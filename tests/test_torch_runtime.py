"""The PyTorch port's controller runtime and leader election against the
JAX package's, on the CPU.

Every test of the JAX package's ``tests/test_runtime.py`` (the bounded
fan-out, the threaded controller runtime with its crash isolation,
leader election over memory, file and apiserver lease stores and the
runtime's gating on it, the Operator's admission backstops, the async
runtime in API mode, and the cluster endpoint override) is replayed on
both packages by ``test_torch_replay``: the test's own checks run on
each, and the two must make the same Operators, clouds and apiserver
objects (tolerances in ``test_torch_replay``; everything else exact).
The two tests that provision on the wall clock under the threaded
runtime are named in ``THREADED``.
"""

import pytest

import test_torch_replay as replay
from test_torch_replay import one_torch_thread  # noqa: F401 (autouse)

FILE = "test_runtime.py"
NOT_REPLAYED = {}
THREADED = {
    "test_runtime.py::TestControllerRuntime::test_async_operator_provisions_real_time",
    "test_runtime.py::TestAsyncApiMode::test_threaded_runtime_over_apiserver",
}


@pytest.mark.parametrize("test_id", replay.replayed(FILE, NOT_REPLAYED))
def test_runtime_equal_to_jax(test_id, tmp_path):
    replay.replay(FILE, test_id, tmp_path, threaded=test_id in THREADED)


def test_runtime_replays_cover_the_jax_tests():
    """Every test of test_runtime.py is replayed or named in NOT_REPLAYED with the
    roadmap item that brings it."""
    names = replay.jax_tests(FILE)
    assert len(names) == 25
    assert THREADED <= set(names)
    assert set(replay.replayed(FILE, NOT_REPLAYED)) | set(NOT_REPLAYED) \
        == set(names)
