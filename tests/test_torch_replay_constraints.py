"""The JAX package's ``tests/test_relaxation.py``, ``tests/test_topology.py``
and ``tests/test_volumes.py`` replayed on both packages, on the CPU.

Preference relaxation, topology (hostname and zone anti-affinity and
spread, the cfg3 composite) and volumes (zonal topology, attach limits,
the binding lifecycle) run through ``test_torch_replay`` with
``plans=True``: the test's own checks run on each package, and the two
must make the same Operators and plans (tolerances in
``test_torch_replay``; everything else exact).
"""

import pytest

import test_torch_replay as replay
from test_torch_replay import one_torch_thread  # noqa: F401 (autouse)

FILES = {"test_relaxation.py": {}, "test_topology.py": {},
         "test_volumes.py": {}}
CASES = [(f, t, p) for f, nr in FILES.items()
         for t, p in replay.parametrized(f, replay.replayed(f, nr))]


@pytest.mark.parametrize("filename,test_id,params", CASES,
                         ids=[replay.case_id(t, p) for _, t, p in CASES])
def test_constraints_equal_to_jax(filename, test_id, params, tmp_path):
    replay.replay(filename, test_id, tmp_path, plans=True, params=params)


@pytest.mark.parametrize("filename,count", [
    ("test_relaxation.py", 11), ("test_topology.py", 27),
    ("test_volumes.py", 21)])
def test_constraints_replays_cover_the_jax_tests(filename, count):
    """Every test of the file is replayed."""
    names = replay.jax_tests(filename)
    assert len(names) == count
    assert replay.replayed(filename, FILES[filename]) == names
