"""The JAX package's ``tests/test_solver.py`` replayed on both packages,
on the CPU.

Every test of the device solver's own file (packing, bin budgets,
constraints, anti-affinity, existing capacity, NodePools, daemonsets,
oracle parity, the lean decode buffer, the native C++ referee and its
fuzzed parity with the Python oracle, batched probes, kubelet caps,
startup taints, warm start, the fuzzed envelope, OS scheduling, the
accelerator bin split and the metamorphic invariances) runs through
``test_torch_replay`` with ``plans=True``: the test's own checks run on
each package, and the plans of every solve must be equal (tolerances in
``test_torch_replay``; everything else exact). Parametrized tests replay
once per parameter set. The one test that reads XLA's jit cache is named
in ``NOT_REPLAYED``.
"""

import pytest

import test_torch_replay as replay
from test_torch_replay import one_torch_thread  # noqa: F401 (autouse)

FILE = "test_solver.py"
NOT_REPLAYED = {
    "test_solver.py::TestWarmup::test_warmup_compiles_and_solve_reuses":
        "XLA (it reads the size of the pack's jit cache, "
        "``_cache_size``: a torch pack has no trace cache)",
}
CASES = replay.parametrized(FILE, replay.replayed(FILE, NOT_REPLAYED))


@pytest.mark.parametrize("test_id,params", CASES,
                         ids=[replay.case_id(t, p) for t, p in CASES])
def test_solver_equal_to_jax(test_id, params, tmp_path):
    replay.replay(FILE, test_id, tmp_path, plans=True, params=params)


def test_solver_replays_cover_the_jax_tests():
    """Every test of test_solver.py is replayed or named in NOT_REPLAYED
    with its reason; none of the warm-start or native referee tests is
    left out."""
    names = replay.jax_tests(FILE)
    assert len(names) == 65
    assert set(replay.replayed(FILE, NOT_REPLAYED)) | set(NOT_REPLAYED) \
        == set(names)
    replayed = set(replay.replayed(FILE, NOT_REPLAYED))
    assert "test_solver.py::TestWarmup::test_background_warmup_joins" \
        in replayed
    assert {n for n in names if "Native" in n} <= replayed
