"""The operator's tools of this package, counterparts of the repository's
``tools/``. Each imports this package only (never the JAX package, never
the repository's ``tools/``), and each that drives an Operator puts its
Solver on ``--device`` (default ``cuda``) and writes its JSON under a name
of its own (``*_gpu_*``), never over the JAX rounds' artifacts.

    python -m karpenter_provider_aws_tpu_torch.tools.kpctl --server URL VERB
    python -m karpenter_provider_aws_tpu_torch.tools.soak
    python -m karpenter_provider_aws_tpu_torch.tools.gen_crds [--check]
    python -m karpenter_provider_aws_tpu_torch.tools.gen_docs
    python -m karpenter_provider_aws_tpu_torch.tools.allocatable_diff
    python -m karpenter_provider_aws_tpu_torch.tools.import_reference_data
    python -m karpenter_provider_aws_tpu_torch.tools.kompat
    python -m karpenter_provider_aws_tpu_torch.tools.lint.run --check
    python -m karpenter_provider_aws_tpu_torch.tools.bench_interruption
    python -m karpenter_provider_aws_tpu_torch.tools.bench_explain
    python -m karpenter_provider_aws_tpu_torch.tools.bench_headroom
    python -m karpenter_provider_aws_tpu_torch.tools.profile_run
    python -m karpenter_provider_aws_tpu_torch.tools.smoke_<name> [--device cuda]
    bash karpenter_provider_aws_tpu_torch/tools/ci.sh [--fast]

The twelve CI gates ``smoke_{introspect,delta,writepath,weather,explain,
headroom,profile,consolidation,pool,sharded,microloop,handoff}`` are the
counterparts of the repository's ``tools/smoke_*.py``, with the same
assertions, sizes, seeds and bounds; ``gate`` holds what they share (the
``--device`` flag, the device line each prints with its kernel launches).
``ci.sh`` runs the repository gate's sixteen steps on this package's
modules, ``DEVICE`` (default ``cuda``) passed as ``--device`` to every
gate and to the bench.

``churn`` holds the operator churn loop that ``bench_explain`` and
``bench_headroom`` share; ``overhead_order`` runs the three overhead
gates' pairs twice in one process, in both orders.
"""
