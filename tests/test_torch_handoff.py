"""The PyTorch port's warm-standby replication against the JAX package's,
on the CPU.

- Every test of the JAX package's ``tests/test_handoff.py`` (the snapshot
  and delta stream, the cutover ladder's rungs, the promotion gate,
  fencing, the crash-safe lease file, the orphaned-lease sweep and the
  operator-kill weather) is replayed on both packages by
  ``test_torch_replay``, with every ``ReplicationSource`` and
  ``StandbyReplica`` they make compared (counters and the names in the
  standby's mirror).
- Over the wire, in each pairing of the two packages (a port leader
  streaming to a port standby, and each package's leader streaming to the
  other's standby): the snapshot, a delta after churn, a stale anchor
  re-snapshotted in the same poll, and the promotion gate against a
  leader that went away. The standby's mirror equals the leader's as
  serde documents after every sync.

Tolerance: none.
"""

import json

import pytest

import test_torch_cases as cases
import test_torch_replay as replay
from test_torch_replay import one_torch_thread  # noqa: F401 (autouse)

FILE = "test_handoff.py"
NOT_REPLAYED = {}


def _params(tests):
    return [pytest.param(test_id, params, id=test_id + (
        f"[{','.join(map(str, params.values()))}]" if params else ""))
        for test_id, params in replay.parametrized(FILE, tests)]


@pytest.mark.parametrize("test_id,params",
                         _params(replay.replayed(FILE, NOT_REPLAYED)))
def test_handoff_equal_to_jax(test_id, params, tmp_path):
    replay.replay(FILE, test_id, tmp_path, params=params)


def test_handoff_replays_cover_the_jax_tests():
    names = replay.jax_tests(FILE)
    assert len(names) == 21
    assert set(replay.replayed(FILE, NOT_REPLAYED)) | set(NOT_REPLAYED) \
        == set(names)


# ---- the stream over the wire ----

def _mirror(pkg, cluster):
    """The mirror as serde documents, the way a snapshot carries it."""
    serde = cases.mod(pkg, "apis.serde")
    return json.dumps({
        "pods": [serde.pod_to_dict(p) for _, p in sorted(cluster.pods.items())],
        "nodes": [serde.node_to_dict(n) for _, n in sorted(cluster.nodes.items())],
        "claims": [serde.nodeclaim_to_dict(c)
                   for _, c in sorted(cluster.claims.items())],
        "leases": [serde.lease_to_dict(lease)
                   for _, lease in sorted(cluster.leases.items())],
    }, sort_keys=True)


def _leader(pkg):
    A = cases.mod(pkg, "apis")
    c = cases.mod(pkg, "state.cluster").ClusterState()
    c.add_node(A.Node(name="n-0", provider_id="fake:///us-east-1a/i-0",
                      ready=True))
    c.add_claim(A.NodeClaim(name="n-0", node_pool="default",
                            instance_type="m5.large", zone="us-east-1a",
                            capacity_type="on-demand"))
    for i in range(3):
        p = A.Pod(name=f"p-{i}", requests={"cpu": "1", "memory": "1Gi"})
        if i == 0:
            p.node_name = "n-0"
        c.add_pod(p)
    return c


@pytest.mark.parametrize("leader_pkg,standby_pkg", [
    (cases.TORCH_PKG, cases.TORCH_PKG), (cases.JAX_PKG, cases.TORCH_PKG),
    (cases.TORCH_PKG, cases.JAX_PKG)], ids=["port-port", "jax-port",
                                            "port-jax"])
def test_standby_mirrors_the_leader_over_the_wire(leader_pkg, standby_pkg,
                                                  tmp_path):
    A = cases.mod(leader_pkg, "apis")
    L = cases.mod(leader_pkg, "state.replication")
    S = cases.mod(standby_pkg, "state.replication")
    cluster = _leader(leader_pkg)
    source = L.ReplicationSource(cluster)
    address = f"unix:{tmp_path}/repl.sock"
    server = L.serve_replication(L.ReplicationService(source), address)
    client = S.ReplicationClient(address)
    replica = S.StandbyReplica(
        cases.mod(standby_pkg, "state.cluster").ClusterState(), client)
    try:
        assert client.health() == {"version": 1, "anchor": cluster.state_rev}
        assert replica.sync_once()
        assert replica.stats()["snapshots"] == 1
        assert _mirror(standby_pkg, replica.cluster) == \
            _mirror(leader_pkg, cluster)
        # churn rides a delta: a new pod, a deleted one, a bind, a lease
        cluster.add_pod(A.Pod(name="p-9", requests={"cpu": "2"}))
        cluster.delete_pod("p-1")
        cluster.bind_pod("p-2", "n-0")
        cluster.add_lease(cases.mod(leader_pkg, "apis.objects").Lease(
            name="n-0", owner_node="n-0"))
        assert replica.sync_once()
        st = replica.stats()
        assert (st["snapshots"], st["deltas"]) == (1, 1)
        assert replica.anchor == cluster.state_rev
        assert _mirror(standby_pkg, replica.cluster) == \
            _mirror(leader_pkg, cluster)
        # an anchor the journal cannot answer re-snapshots in one poll
        replica.anchor = 10 ** 9
        assert replica.sync_once()
        assert replica.stats()["stale_anchor_rebuilds"] == 1
        assert _mirror(standby_pkg, replica.cluster) == \
            _mirror(leader_pkg, cluster)
        assert replica.promotion_ready()
        assert replica.stats()["stale_promotions"] == 0
    finally:
        server.stop(grace=None)
    # the leader is gone: the gate promotes on the held (stale) state
    assert replica.promotion_ready()
    st = replica.stats()
    assert st["stale_promotions"] == 1 and st["poll_errors"] == 1
    assert "UNAVAILABLE" in st["last_error"]
    client.close()
