"""The PyTorch port's Operator in API mode against the JAX package's, on
the CPU.

Every test of the JAX package's ``tests/test_apiserver_e2e.py`` but one
(provisioning through the apiserver, NodePools and NodeClasses written
over the API and guarded by admission and the config guard,
consolidation and PDB-gated drains, interruption, the NodePool deletion
cascade, events mirrored into the server, and the pools' status
resources) is replayed on both packages by ``test_torch_replay``: the
test's own checks run on each, and the two must make the same Operators
(claims, nodes, bindings, events) and leave the same objects, with the
same resourceVersions and counters, in the apiserver (tolerances in
``test_torch_replay``; everything else exact). The test that renders
events with ``kpctl`` in process runs the port's kpctl on the port side.
"""

import pytest

import test_torch_replay as replay
from test_torch_replay import one_torch_thread  # noqa: F401 (autouse)

FILE = "test_apiserver_e2e.py"
NOT_REPLAYED = {}
SHIMS = (replay.KPCTL_SHIM,)
THREADED = set()


@pytest.mark.parametrize("test_id", replay.replayed(FILE, NOT_REPLAYED))
def test_apiserver_e2e_equal_to_jax(test_id, tmp_path):
    replay.replay(FILE, test_id, tmp_path, shims=SHIMS,
                  threaded=test_id in THREADED)


def test_apiserver_e2e_replays_cover_the_jax_tests():
    """Every test of test_apiserver_e2e.py is replayed or named in NOT_REPLAYED with the
    roadmap item that brings it."""
    names = replay.jax_tests(FILE)
    assert len(names) == 20
    assert THREADED <= set(names)
    assert set(replay.replayed(FILE, NOT_REPLAYED)) | set(NOT_REPLAYED) \
        == set(names)
