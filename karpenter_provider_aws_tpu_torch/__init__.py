"""PyTorch + CUDA port of karpenter_provider_aws_tpu for one NVIDIA H100.

The same pending pods, NodePools and instance-type lattice go in, and the
same NodePlan comes out, as the JAX package gives. This package imports
torch and numpy, never jax and never the JAX package: what it needs of
the JAX package's pure-numpy modules (apis, lattice, masks, problem
building, the FFD oracle) it carries as its own copies, in the same
layout, so each module's counterpart is found by its path.

Entry points: ``solver.Solver(lattice, device=None)`` — the device is
``cuda`` unless the caller asks for ``"cpu"`` — and, over it, the
provisioning controller (``controllers.Provisioner`` on a
``state.ClusterState``, with ``cloudprovider.CloudProvider`` over
``cloud.FakeCloud``; ``workloads.ProvisionerStack`` wires one).
"""
