"""The PyTorch port's CLI against the JAX package's, on the CPU.

Every test of the JAX package's ``tests/test_cli.py`` but one (flags and
the environment into Options, feature gates, the metrics and health
server, the main loop, the HTTP admission endpoint in both review
dialects, and ``--api-port`` serving the apiserver to an external agent)
is replayed on both packages by ``test_torch_replay`` (on the port side
``--device`` defaults to the CPU there): the test's own checks run on
each, and the two must make the same Operators and apiserver objects
(tolerances in ``test_torch_replay``; everything else exact). The two
tests whose ``main`` runs on the wall clock are named in ``THREADED``.
The test of the JAX profiler hook is named in ``NOT_REPLAYED``: the
port's CLI refuses ``--profile-dir`` (``test_torch_api_slice.py``).
"""

import pytest

import test_torch_replay as replay
from test_torch_replay import one_torch_thread  # noqa: F401 (autouse)

FILE = "test_cli.py"
NOT_REPLAYED = {
    "test_cli.py::TestProfilingHook::test_solver_trace_writes_xprof_artifacts":
        "B7 (Solver.start_profiling writes a JAX profiler trace)",
}
THREADED = {
    "test_cli.py::TestMainLoop::test_main_runs_for_duration_and_exits",
    "test_cli.py::TestApiPortFlag::test_cli_serves_apiserver_rest",
}


@pytest.mark.parametrize("test_id", replay.replayed(FILE, NOT_REPLAYED))
def test_cli_equal_to_jax(test_id, tmp_path):
    replay.replay(FILE, test_id, tmp_path, threaded=test_id in THREADED)


def test_cli_replays_cover_the_jax_tests():
    """Every test of test_cli.py is replayed or named in NOT_REPLAYED with the
    roadmap item that brings it."""
    names = replay.jax_tests(FILE)
    assert len(names) == 11
    assert THREADED <= set(names)
    assert set(replay.replayed(FILE, NOT_REPLAYED)) | set(NOT_REPLAYED) \
        == set(names)
