"""The JAX package's ``tests/test_incremental.py`` and
``tests/test_scale.py`` replayed on both packages, on the CPU.

The incremental problem builder (dirty journals, delta re-tensorization,
its parity with scratch builds over churn), the SLO warmup window with
``Solver.warmup``'s ``on_done``, the boot satellites, and the scale
scenarios (node- and pod-dense scale-ups, the deprovisioning matrix, ICE
chaos, the kitchen sink, each in direct and API mode, and API-mode scale
and consolidation) run through ``test_torch_replay`` with ``plans=True``:
the test's own checks run on each package, and the two must make the same
Operators, clouds, apiservers, metric series and plans (tolerances in
``test_torch_replay``; everything else exact). Tests over a parametrized
fixture (``stratum``) replay once per value. The persistent compile
cache's test is named in ``NOT_REPLAYED``: the port compiles nothing at
run time (a settled seam).
"""

import pytest

import test_torch_replay as replay
from test_torch_replay import one_torch_thread  # noqa: F401 (autouse)

FILES = {
    "test_incremental.py": {
        "test_incremental.py::TestBootSatellites::"
        "test_enable_persistent_compile_cache":
            "seam (the port compiles nothing at run time, so there is no "
            "persistent compile cache to enable; the CLI and the Operator "
            "refuse COMPILE_CACHE_DIR)",
    },
    "test_scale.py": {},
}
CASES = [(f, t, p) for f, nr in FILES.items()
         for t, p in replay.parametrized(f, replay.replayed(f, nr))]


@pytest.mark.parametrize("filename,test_id,params", CASES,
                         ids=[replay.case_id(t, p) for _, t, p in CASES])
def test_incremental_and_scale_equal_to_jax(filename, test_id, params,
                                            tmp_path):
    replay.replay(filename, test_id, tmp_path, plans=True, params=params)


@pytest.mark.parametrize("filename,count", [("test_incremental.py", 24),
                                            ("test_scale.py", 7)])
def test_incremental_and_scale_replays_cover_the_jax_tests(filename, count):
    """Every test of the file is replayed or named in NOT_REPLAYED with
    its reason; the warm-start test replays."""
    names = replay.jax_tests(filename)
    assert len(names) == count
    nr = FILES[filename]
    assert set(replay.replayed(filename, nr)) | set(nr) == set(names)
    assert "test_incremental.py::TestSloWarmupWindow::" \
        "test_solver_warmup_on_done_fires" in \
        replay.replayed("test_incremental.py", FILES["test_incremental.py"])
