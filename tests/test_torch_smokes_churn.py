"""The PyTorch port's churn gates on the CPU against the JAX package's:
``smoke_delta`` (20 small-churn passes on the delta path), ``smoke_consolidation``
(six anti-affine nodes consolidated under budgets) and ``smoke_writepath``
(the API stratum's coalesced writes).

Each port gate (``karpenter_provider_aws_tpu_torch/tools/smoke_<name>.py``,
``--device cpu``) runs in a subprocess beside the repository's own
``tools/smoke_<name>.py`` (``JAX_PLATFORMS=cpu``), and both must exit 0.
Their summaries follow from a FakeClock and the gates' seeds alone, so the
two summary lines must be equal character for character (every count: delta
solves, incremental builds, parity passes, resident hits; nodes
consolidated, savings, dispatches, candidate sets, cache hits, referee
checks, budget skips; bulk calls, ops and binds, events delivered,
watchers, pods converged). No field of these lines is wall-clock derived.

Tolerance: none.
"""

import pytest

from test_torch_smokes import check_port, run_both, summary


@pytest.mark.parametrize("name", ["delta", "consolidation", "writepath"])
def test_gate_summary_equals_the_jax_gates(name):
    port, jax = run_both(name)
    assert check_port(name, port) == summary(jax)
