"""The PyTorch port's write path against the JAX package's, on the CPU.

Every test of the JAX package's ``tests/test_writepath.py`` (frozen
envelopes shared by reads and deliveries, bookmarks, bounded watch
queues and the relist after an overflow, the bulk verb with per-op
errors and admission, the ``ApiWriter``'s batching into bulk calls, the
real inverted field indexes, linearizability per kind, and ``stats()``)
is replayed on both packages by ``test_torch_replay``: the test's own
checks run on each, and the two must leave the same objects, with the
same resourceVersions, bulk calls, bookmarks and dropped-watcher
counts, in every apiserver they made (tolerances in
``test_torch_replay``; everything else exact). The tests whose writers
race on threads are named in ``THREADED``.
"""

import pytest

import test_torch_replay as replay
from test_torch_replay import one_torch_thread  # noqa: F401 (autouse)

FILE = "test_writepath.py"
NOT_REPLAYED = {}
THREADED = {
    "test_writepath.py::TestBoundedQueues::test_threaded_informer_recovers_from_overflow",
    "test_writepath.py::TestLinearizability::test_multi_writer_multi_watcher_race",
    "test_writepath.py::TestLinearizability::test_watch_stream_replays_to_exact_store_state",
    "test_writepath.py::TestLinearizability::test_rv_monotonic_per_kind_across_concurrent_kinds",
}


@pytest.mark.parametrize("test_id", replay.replayed(FILE, NOT_REPLAYED))
def test_writepath_equal_to_jax(test_id, tmp_path):
    replay.replay(FILE, test_id, tmp_path, threaded=test_id in THREADED)


def test_writepath_replays_cover_the_jax_tests():
    """Every test of test_writepath.py is replayed or named in NOT_REPLAYED with the
    roadmap item that brings it."""
    names = replay.jax_tests(FILE)
    assert len(names) == 33
    assert THREADED <= set(names)
    assert set(replay.replayed(FILE, NOT_REPLAYED)) | set(NOT_REPLAYED) \
        == set(names)
