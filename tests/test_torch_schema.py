"""The PyTorch port's wire schema and its validation against the JAX
package's, on the CPU.

Every test of the JAX package's ``tests/test_schema.py`` but one (valid
objects round-trip, structural rejection with ``jsonschema``'s error
strings, the CEL-style cross-field rules, admission through the
apiserver, and the generated CRD documents) is replayed on both packages
by ``test_torch_replay``: the test's own checks run on each, and the two
must leave the same objects in every apiserver they made (tolerances in
``test_torch_replay``; everything else exact). The port validates with
its own Draft 2020-12 validator, not ``jsonschema``;
``test_torch_schema_validator.py`` holds it to ``jsonschema`` on
generated specs. The test that regenerates the checked-in CRDs runs the
port's generator on the port side (``python -m
karpenter_provider_aws_tpu_torch.tools.gen_crds --check``), which renders
``deploy/crds/`` byte for byte from the port's schema.
"""

import pytest

import test_torch_replay as replay
from test_torch_replay import one_torch_thread  # noqa: F401 (autouse)

FILE = "test_schema.py"
NOT_REPLAYED = {}
SHIMS = (('[sys.executable, str(REPO / "tools" / "gen_crds.py"), "--check"],',
          '[sys.executable, "-m", '
          '"karpenter_provider_aws_tpu_torch.tools.gen_crds", "--check"], '
          'cwd=str(REPO),'),)
THREADED = set()


@pytest.mark.parametrize("test_id", replay.replayed(FILE, NOT_REPLAYED))
def test_schema_equal_to_jax(test_id, tmp_path):
    replay.replay(FILE, test_id, tmp_path, shims=SHIMS,
                  threaded=test_id in THREADED)


def test_schema_replays_cover_the_jax_tests():
    """Every test of test_schema.py is replayed or named in NOT_REPLAYED with the
    roadmap item that brings it."""
    names = replay.jax_tests(FILE)
    assert len(names) == 23
    assert THREADED <= set(names)
    assert set(replay.replayed(FILE, NOT_REPLAYED)) | set(NOT_REPLAYED) \
        == set(names)
