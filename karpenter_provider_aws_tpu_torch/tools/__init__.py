"""Host-side benches of this package, counterparts of the repository's
``tools/bench_*.py`` and ``tools/profile_run.py``: each drives an
Operator, and with it a Solver on ``--device`` (default ``cuda``), and
writes its JSON under a name of its own (``*_gpu_r01*.json``), never over
the JAX rounds' artifacts.

    python -m karpenter_provider_aws_tpu_torch.tools.bench_interruption
    python -m karpenter_provider_aws_tpu_torch.tools.bench_explain
    python -m karpenter_provider_aws_tpu_torch.tools.bench_headroom
    python -m karpenter_provider_aws_tpu_torch.tools.profile_run

``churn`` holds the operator churn loop that ``bench_explain`` and
``bench_headroom`` share; ``overhead_order`` runs the three overhead
gates' pairs twice in one process, in both orders.
"""
