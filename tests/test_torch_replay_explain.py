"""The JAX package's ``tests/test_explain.py`` and
``tests/test_metrics_lint.py`` replayed on both packages, on the CPU.

Decision explainability (the constraint-elimination ledgers, the reason
taxonomy, the solve codes, the provisioner's audit ring and its debug
routes) and the Prometheus exposition linter (its rules and a live
Operator's scrape) run through ``test_torch_replay`` with ``plans=True``:
the test's own checks run on each package, and the two must make the same
Operators, metric series and plans (tolerances in ``test_torch_replay``;
everything else exact). The tests of ``tools/kpctl.py`` run the port's
kpctl on the port side.
"""

import pytest

import test_torch_replay as replay
from test_torch_replay import one_torch_thread  # noqa: F401 (autouse)

FILES = {
    "test_explain.py": {},
    "test_metrics_lint.py": {},
}
SHIMS = {"test_explain.py": (replay.KPCTL_SHIM,)}
CASES = [(f, t, p) for f, nr in FILES.items()
         for t, p in replay.parametrized(f, replay.replayed(f, nr))]


@pytest.mark.parametrize("filename,test_id,params", CASES,
                         ids=[replay.case_id(t, p) for _, t, p in CASES])
def test_explain_and_lint_equal_to_jax(filename, test_id, params, tmp_path):
    replay.replay(filename, test_id, tmp_path, plans=True, params=params,
                  shims=SHIMS.get(filename, ()))


@pytest.mark.parametrize("filename,count", [("test_explain.py", 39),
                                            ("test_metrics_lint.py", 18)])
def test_explain_and_lint_replays_cover_the_jax_tests(filename, count):
    """Every test of the file is replayed or named in NOT_REPLAYED with
    the roadmap item that brings it."""
    names = replay.jax_tests(filename)
    assert len(names) == count
    nr = FILES[filename]
    assert set(replay.replayed(filename, nr)) | set(nr) == set(names)
