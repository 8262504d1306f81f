"""PyTorch + CUDA port of karpenter_provider_aws_tpu for one NVIDIA H100.

The same pending pods, NodePools and instance-type lattice go in, and the
same NodePlan comes out, as the JAX package gives. This package imports
torch and numpy, never jax and never the JAX package: what it needs of
the JAX package's pure-numpy modules (apis, lattice, masks, problem
building, the FFD oracle) it carries as its own copies, in the same
layout, so each module's counterpart is found by its path.

Entry points: ``python -m karpenter_provider_aws_tpu_torch`` (``cli.py``:
the control plane as a process, with the apiserver's REST surface, the
metrics server and the controller runtime under leader election);
``operator.Operator(..., device=None)``, every controller over one Solver,
in direct mode or, with ``api_server=``, in API mode; and beneath them
``solver.Solver(lattice, device=None)``. The device is ``cuda`` unless
the caller asks for ``"cpu"``.
"""

__version__ = "0.4.0"
