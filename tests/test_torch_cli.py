"""The PyTorch port's CLI against the JAX package's, on the CPU.

Every test of the JAX package's ``tests/test_cli.py`` (flags and
the environment into Options, feature gates, the metrics and health
server, the main loop, the HTTP admission endpoint in both review
dialects, and ``--api-port`` serving the apiserver to an external agent)
is replayed on both packages by ``test_torch_replay`` (on the port side
``--device`` defaults to the CPU there): the test's own checks run on
each, and the two must make the same Operators and apiserver objects
(tolerances in ``test_torch_replay``; everything else exact). The two
tests whose ``main`` runs on the wall clock are named in ``THREADED``.
The profiler hook's test replays too: the port's ``start_profiling``
writes its trace where the reference's does, under
``<dir>/plugins/profile/<run>/``.
"""

import pytest

import test_torch_replay as replay
from test_torch_replay import one_torch_thread  # noqa: F401 (autouse)

FILE = "test_cli.py"
NOT_REPLAYED = {}
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
