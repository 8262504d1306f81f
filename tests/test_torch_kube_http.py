"""The PyTorch port's REST surface (``kube/httpserver.py``) against the JAX
package's, on the CPU.

Every test of the JAX package's ``tests/test_kube_http.py`` that drives
the surface over HTTP (the REST verbs and their status codes, admission
422s with causes, the binding and eviction subresources, the chunked
watch stream with 410 and the reflector's relist, the bearer token, TLS
and a stalled TLS client, the CLI's refusal of a public plaintext bind,
an external agent driving an API-mode Operator, discovery, heartbeats,
and ``tools/kpctl.py`` as a separate process closing its pipe early) is
replayed on both packages by ``test_torch_replay``: the test's own
checks run on each, and the two must leave the same objects, with the
same resourceVersions and counters, in every apiserver they made
(tolerances in ``test_torch_replay``; everything else exact). On the
port side kpctl is the port's, in process and as the subprocess
(``python -m karpenter_provider_aws_tpu_torch.tools.kpctl``). The tests whose
watch streams subscribe and unsubscribe on the server's handler threads,
on the wall clock, are named in ``THREADED``.
"""

import pytest

import test_torch_replay as replay
from test_torch_replay import one_torch_thread  # noqa: F401 (autouse)

FILE = "test_kube_http.py"
NOT_REPLAYED = {}
SHIMS = (replay.KPCTL_SHIM,
         ("[_sys.executable, str(kpctl), \"--server\", base,",
          "[_sys.executable, \"-m\", "
          "\"karpenter_provider_aws_tpu_torch.tools.kpctl\", "
          "\"--server\", base,"))
THREADED = {
    "test_kube_http.py::TestWatchStream::test_watch_delivers_events_as_json_lines",
    "test_kube_http.py::TestWatchReconnectOver410::test_reflector_relists_after_410_over_http",
    "test_kube_http.py::TestWatchHeartbeat::test_idle_watch_emits_heartbeats_then_resumes_events",
}


@pytest.mark.parametrize("test_id", replay.replayed(FILE, NOT_REPLAYED))
def test_kube_http_equal_to_jax(test_id, tmp_path):
    replay.replay(FILE, test_id, tmp_path, shims=SHIMS,
                  threaded=test_id in THREADED)


def test_kube_http_replays_cover_the_jax_tests():
    """Every test of test_kube_http.py is replayed or named in NOT_REPLAYED with the
    roadmap item that brings it."""
    names = replay.jax_tests(FILE)
    assert len(names) == 27
    assert THREADED <= set(names)
    assert set(replay.replayed(FILE, NOT_REPLAYED)) | set(NOT_REPLAYED) \
        == set(names)
