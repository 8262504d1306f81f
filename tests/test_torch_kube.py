"""The PyTorch port's fake apiserver, typed client, informers and event
sink against the JAX package's, on the CPU.

Every test of the JAX package's ``tests/test_kube.py`` (the verbs and
their resourceVersions, finalizers, watches and ``TooOldError``, the
binding and eviction subresources with PDBs, field indexes, admission at
the boundary, informers and the informer set, the client's round trips,
the review regressions, and the event sink mirroring events into the
server) is replayed on both packages by ``test_torch_replay``: the
test's own checks run on each, and the two must leave the same objects
in every apiserver they made, with the same resourceVersions and the
same ``stats()`` counters (tolerances in ``test_torch_replay``;
everything else exact). The threaded informer's tests follow the wall
clock and are named in ``THREADED``.
"""

import pytest

import test_torch_replay as replay
from test_torch_replay import one_torch_thread  # noqa: F401 (autouse)

FILE = "test_kube.py"
NOT_REPLAYED = {}
THREADED = {
    "test_kube.py::TestWatch::test_blocking_get_wakes_on_event",
    "test_kube.py::TestInformer::test_threaded_informer_converges",
}


@pytest.mark.parametrize("test_id", replay.replayed(FILE, NOT_REPLAYED))
def test_kube_equal_to_jax(test_id, tmp_path):
    replay.replay(FILE, test_id, tmp_path, threaded=test_id in THREADED)


def test_kube_replays_cover_the_jax_tests():
    """Every test of test_kube.py is replayed or named in NOT_REPLAYED
    with the roadmap item that brings it."""
    names = replay.jax_tests(FILE)
    assert len(names) == 46
    assert THREADED <= set(names)
    assert set(replay.replayed(FILE, NOT_REPLAYED)) | set(NOT_REPLAYED) \
        == set(names)
