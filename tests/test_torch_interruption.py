"""The PyTorch port's interruption controller and metrics surface against
the JAX package's, on the CPU.

Every test of the JAX package's ``tests/test_interruption.py`` (the four
message schemas and the parser, spot interruption, rebalance, scheduled
change, the message and core metric series, the cloud-provider
decoration, the Prometheus rendering) is replayed on both packages by
``test_torch_replay``: the test's own checks run on each, and the two
must make the same claims, events, cloud calls, queue contents and
metric series (tolerances in ``test_torch_replay``; everything else
exact). The one exception is named in ``NOT_REPLAYED``.
"""

import pytest

import test_torch_replay as replay

FILE = "test_interruption.py"
NOT_REPLAYED = {
    # imports tools/bench_interruption.py, which builds the JAX package's
    # Operator; a port copy of the tools comes with them
    "test_interruption.py::TestThroughputHarness::test_drain_2000_messages":
        "A12 (tools)",
}


@pytest.mark.parametrize("test_id", replay.replayed(FILE, NOT_REPLAYED))
def test_interruption_equal_to_jax(test_id, tmp_path):
    replay.replay(FILE, test_id, tmp_path)


def test_interruption_replays_cover_the_jax_tests():
    """Every test of test_interruption.py is replayed or named in
    NOT_REPLAYED with the roadmap item that brings it."""
    names = replay.jax_tests(FILE)
    assert len(names) == 19
    assert set(replay.replayed(FILE, NOT_REPLAYED)) | set(NOT_REPLAYED) \
        == set(names)
