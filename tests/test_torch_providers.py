"""The PyTorch port's domain providers, NodeClass controller and
admission webhooks against the JAX package's, on the CPU.

Every test of the JAX package's ``tests/test_providers.py`` (subnet,
security-group, instance-profile, AMI, launch-template, pricing and
version providers, the NodeClass controller, the admission webhooks) is
replayed on both packages by ``test_torch_replay``: the test's own checks
run on each, and the two must hold the same provider cache contents,
prices, cloud calls and Operator state (tolerances in
``test_torch_replay``; everything else exact).
"""

import pytest

import test_torch_replay as replay

FILE = "test_providers.py"
NOT_REPLAYED = {}


@pytest.mark.parametrize("test_id", replay.replayed(FILE, NOT_REPLAYED))
def test_providers_equal_to_jax(test_id, tmp_path):
    replay.replay(FILE, test_id, tmp_path)


def test_providers_replays_cover_the_jax_tests():
    """Every test of test_providers.py is replayed or named in
    NOT_REPLAYED with the roadmap item that brings it."""
    names = replay.jax_tests(FILE)
    assert len(names) == 45
    assert set(replay.replayed(FILE, NOT_REPLAYED)) | set(NOT_REPLAYED) \
        == set(names)
