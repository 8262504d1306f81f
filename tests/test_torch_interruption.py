"""The PyTorch port's interruption controller and metrics surface against
the JAX package's, on the CPU.

Every test of the JAX package's ``tests/test_interruption.py`` (the four
message schemas and the parser, spot interruption, rebalance, scheduled
change, the message and core metric series, the cloud-provider
decoration, the Prometheus rendering, the throughput harness) is replayed
on both packages by ``test_torch_replay``: the test's own checks run on
each, and the two must make the same claims, events, cloud calls, queue
contents and metric series (tolerances in ``test_torch_replay``;
everything else exact). The throughput harness imports the repository's
``tools/bench_interruption.py``; on the port side ``SHIMS`` point it at the
port's copy (``karpenter_provider_aws_tpu_torch/tools``) with its
Operator on the CPU. No test is left out (``NOT_REPLAYED`` is empty).
"""

import pytest

import test_torch_replay as replay

FILE = "test_interruption.py"
NOT_REPLAYED = {}
SHIMS = (
    ("from tools.bench_interruption import build_env, drain, seed_messages",
     "from karpenter_provider_aws_tpu_torch.tools.bench_interruption "
     "import build_env, drain, seed_messages"),
    ("env = build_env(lattice)", "env = build_env(lattice, device='cpu')"),
)


@pytest.mark.parametrize("test_id", replay.replayed(FILE, NOT_REPLAYED))
def test_interruption_equal_to_jax(test_id, tmp_path):
    replay.replay(FILE, test_id, tmp_path, shims=SHIMS)


def test_interruption_replays_cover_the_jax_tests():
    """Every test of test_interruption.py is replayed or named in
    NOT_REPLAYED with the roadmap item that brings it."""
    names = replay.jax_tests(FILE)
    assert len(names) == 19
    assert set(replay.replayed(FILE, NOT_REPLAYED)) | set(NOT_REPLAYED) \
        == set(names)
