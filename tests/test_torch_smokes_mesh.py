"""The PyTorch port's mesh gates on the CPU against the JAX package's:
``smoke_sharded`` (an Operator on 8 shards, churn passes refereed by a
single-device Solver) and ``smoke_microloop`` (the device-resident
microloop on the mesh, its link legs per pass within the reference's bound
of 2, or 4 after a tail-bin merge).

The port plans its mesh with ``Options(mesh="8")``: 8 shards batched on
the Solver's device; the repository's gates force an 8-device virtual CPU
mesh through ``XLA_FLAGS``. Each port gate (``--device cpu``) runs in a
subprocess beside the repository's own ``tools/smoke_<name>.py``
(``JAX_PLATFORMS=cpu``), both must exit 0, and their summary lines must be
equal character for character: mesh devices, sharded and delta solves,
resident hits, the shard imbalance and the parity passes; micro and delta
solves, the legs of every delta pass, skipped syncs, merge solves and
skips, overlapped admissions. No field of these lines is wall-clock
derived.

Tolerance: none.
"""

import pytest

from test_torch_smokes import check_port, run_both, summary


@pytest.mark.parametrize("name", ["sharded", "microloop"])
def test_gate_summary_equals_the_jax_gates(name):
    port, jax = run_both(name)
    assert check_port(name, port) == summary(jax)
