"""The JAX package's ``tests/test_requirements.py``, ``tests/test_units.py``,
``tests/test_lattice.py`` and ``tests/test_realdata.py`` replayed on both
packages, on the CPU.

Scheduling requirements and their compatibility rules, resource units
and the structured logger, the lattice (catalog, overhead, tensors) and
the real EC2 catalog's loader and its lattice run through
``test_torch_replay`` with ``plans=True``, module-level tests included:
the test's own checks run on each package, and the two must make the same
plans (tolerances in ``test_torch_replay``; everything else exact). The
importer-freshness test keeps its own ``skipif`` (it needs a checkout of
the upstream project) on both packages.
"""

import pytest

import test_torch_replay as replay
from test_torch_replay import one_torch_thread  # noqa: F401 (autouse)

FILES = {"test_requirements.py": {}, "test_units.py": {},
         "test_lattice.py": {}, "test_realdata.py": {}}
CASES = [(f, t, p) for f, nr in FILES.items()
         for t, p in replay.parametrized(f, replay.replayed(f, nr))]


@pytest.mark.parametrize("filename,test_id,params", CASES,
                         ids=[replay.case_id(t, p) for _, t, p in CASES])
def test_model_equal_to_jax(filename, test_id, params, tmp_path):
    replay.replay(filename, test_id, tmp_path, plans=True, params=params)


@pytest.mark.parametrize("filename,count", [
    ("test_requirements.py", 25), ("test_units.py", 9),
    ("test_lattice.py", 37), ("test_realdata.py", 18)])
def test_model_replays_cover_the_jax_tests(filename, count):
    """Every test of the file, module-level ones included, is replayed."""
    names = replay.jax_tests(filename)
    assert len(names) == count
    assert replay.replayed(filename, FILES[filename]) == names
