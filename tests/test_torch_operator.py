"""The PyTorch port's Operator in direct mode against the JAX package's,
on the CPU.

Every test of the JAX package's ``tests/test_controlplane.py`` (caches,
batcher, fake cloud, the cloud-provider boundary, the provision → launch
→ register → bind loop, tagging, garbage collection, termination,
options, limits, reserved capacity, kubelet max-pods, local zones, IPv6,
leases, the synced gauge and the NodePool deletion cascade) is replayed
on both packages by ``test_torch_replay``: the test's own checks run on
each, and the two must make the same claims, nodes, bindings, events,
cloud calls, provider cache contents and metric series (tolerances in
``test_torch_replay``; everything else exact). The Operator's seams and
cfg4's fleet through it are in ``test_torch_operator_seams.py``.
"""

import pytest

import test_torch_replay as replay

FILE = "test_controlplane.py"
NOT_REPLAYED = {}


@pytest.mark.parametrize("test_id", replay.replayed(FILE, NOT_REPLAYED))
def test_controlplane_equal_to_jax(test_id, tmp_path):
    replay.replay(FILE, test_id, tmp_path)


def test_controlplane_replays_cover_the_jax_tests():
    """Every test of test_controlplane.py is replayed or named in
    NOT_REPLAYED with the roadmap item that brings it."""
    names = replay.jax_tests(FILE)
    assert len(names) == 52
    assert set(replay.replayed(FILE, NOT_REPLAYED)) | set(NOT_REPLAYED) \
        == set(names)
