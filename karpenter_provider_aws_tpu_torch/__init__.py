"""PyTorch + CUDA port of karpenter_provider_aws_tpu for one NVIDIA H100.

The same pending pods, NodePools and instance-type lattice go in, and the
same NodePlan comes out, as the JAX package gives. This package imports
torch and numpy, never jax and never the JAX package: what it needs of
the JAX package's pure-numpy modules (apis, lattice, masks, problem
building, the FFD oracle) it carries as its own copies, in the same
layout, so each module's counterpart is found by its path.

Entry points: ``operator.Operator(..., device=None)``, the control plane
in direct mode with every controller over one Solver, and beneath it
``solver.Solver(lattice, device=None)``. The device is ``cuda`` unless
the caller asks for ``"cpu"``.
"""

__version__ = "0.4.0"
