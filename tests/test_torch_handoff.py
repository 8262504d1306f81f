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


# ---- pods pending at promotion, as the handoff gate meets them ----

class _LocalClient:
    """The replication client without a socket (the service's own JSON
    bodies), as the JAX package's ``tests/test_handoff.py`` has it."""

    def __init__(self, service):
        self._service = service

    def snapshot(self):
        return json.loads(self._service.snapshot(b"{}").decode())

    def delta(self, since):
        return json.loads(self._service.delta(
            json.dumps({"since": since}).encode()).decode())


def _promoted_convergence(pkg, leader_passes, step, last, synced_first):
    """The handoff gate's two Operators in one process on a FakeClock: the
    leader adds two pods before each of ``leader_passes`` passes (``step``
    seconds apart), the standby syncing after each; then ``last`` more pods,
    with the standby's last sync before the leader's pass that places them
    (``synced_first``: the race of the gate's kill) or after it. The
    standby then adopts the fleet as the gate's ``on_promote`` does and
    runs the gate's three convergence passes. Returns the pods pending at
    promotion, the pods bound then, the instance type and pods of each
    claim those passes launched, and the pods that moved."""
    O = cases.mod(pkg, "operator")
    F = cases.mod(pkg, "cloud.fake")
    A = cases.mod(pkg, "apis")
    R = cases.mod(pkg, "state.replication")
    clock = cases.mod(pkg, "utils.clock").FakeClock()
    lat = cases.family_lattice(pkg, ("m5", "c5"))
    kw = {"device": "cpu"} if pkg == cases.TORCH_PKG else {}

    def operator():
        return O.Operator(options=O.Options(registration_delay=0.5),
                          lattice=lat, cloud=F.FakeCloud(clock), clock=clock,
                          **kw)

    leader, standby = operator(), operator()
    source = R.ReplicationSource(leader.cluster)
    replica = R.StandbyReplica(
        standby.cluster, _LocalClient(R.ReplicationService(source)),
        prebuild=lambda: standby.provisioner.warm_build())
    serial = 0

    def add(n):
        nonlocal serial
        for _ in range(n):
            serial += 1
            leader.cluster.add_pod(A.Pod(
                name=f"lp{serial}",
                requests={"cpu": "500m", "memory": "1Gi"}))

    for _ in range(leader_passes):
        add(2)
        leader.run_once(force_provision=True)
        source.tick()
        assert replica.sync_once()
        clock.step(step)
    add(last)
    if synced_first:
        assert replica.sync_once()
        leader.run_once(force_provision=True)
    else:
        leader.run_once(force_provision=True)
        source.tick()
        assert replica.sync_once()
    cl = standby.cluster
    for c in list(cl.claims.values()):
        if c.provider_id:
            iid = F.parse_instance_id(c.provider_id)
            standby.cloud.instances[iid] = F.CloudInstance(
                id=iid, instance_type=c.instance_type or "m5.large",
                zone=c.zone or "us-west-2a",
                capacity_type=c.capacity_type or "on-demand",
                launch_time=c.launched_at or 0.0)
    pending = sorted(p.name for p in cl.pending_pods())
    bound = {p.name: p.node_name for p in cl.pods.values() if p.node_name}
    claims0 = dict(cl.claims)
    held = {}
    for _ in range(3):
        standby.run_once(force_provision=True)
        for name, claim in list(cl.claims.items()):
            if claims0.get(name) is not claim:     # launched since
                held[name] = set(held.get(name, ())) | {
                    p.name for p in cl.nominated_pods(name)} | {
                    p.name for p in cl.pods.values()
                    if p.node_name == name and p.name not in bound}
        clock.step(step)
    return {"pending": pending, "bound": sorted(bound),
            "launched": sorted((c, cl.claims[c].instance_type, sorted(pods))
                               for c, pods in held.items()),
            "moved": sorted(n for n, node in bound.items()
                            if cl.pods[n].node_name != node)}


@pytest.mark.parametrize("leader_passes,step,last,synced_first,launches", [
    (8, 0.3, 2, True, 0), (8, 0.3, 2, False, 0), (8, 0.3, 6, True, 1)],
    ids=["two-pods-unplaced", "two-pods-placed", "six-pods-unplaced"])
def test_pods_pending_at_promotion_placed_as_the_jax_package_places_them(
        leader_passes, step, last, synced_first, launches):
    """The handoff gate's convergence passes in both packages from the same
    replicated mirror: the same pods pending and bound at promotion, the
    same claims launched (name, instance type, pods), no pod moved, and
    every pod a launched claim holds pending at promotion (the gate's
    ``convergence_fault``). Nominations are not replicated, so every pod
    the leader had not bound arrives pending; two such pods fit on the
    fleet the mirror holds, six do not. The launched claim is named
    ``default-00001`` in both packages, a name the leader used too: each
    process numbers its claims from 1."""
    got = {pkg: _promoted_convergence(pkg, leader_passes, step, last,
                                      synced_first)
           for pkg in (cases.TORCH_PKG, cases.JAX_PKG)}
    port = got[cases.TORCH_PKG]
    assert port == got[cases.JAX_PKG]
    assert port["pending"] and port["moved"] == []
    assert len(port["launched"]) == launches
    for name, _, pods in port["launched"]:
        assert pods and set(pods) <= set(port["pending"]), (name, pods)
