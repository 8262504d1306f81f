"""Operator handoff: ClusterState snapshot + dirty-journal delta
streaming to a warm standby (docs/reference/handoff.md).

The reference ships HA as 2 replicas behind lease-based leader election,
where the loser idles COLD: a failover pays a full informer resync, a
cold scheduler, and (here) a compile storm. This module is the warm half
of the handoff story — the dirty journal IS a replication log, so the
same machinery that feeds the incremental problem builder
(`DirtyJournalCoalescer.take`) feeds a standby's mirror:

- :class:`ReplicationSource` (leader side) serializes the whole mirror
  into a VERSIONED snapshot anchored at ``state_rev``, then answers
  incremental delta polls with exactly what the journal localized since
  the standby's anchor — named pods by value (or a tombstone), table
  refreshes for the axes the journal only flags (bins → nodes+claims,
  volumes → PVCs+StorageClasses, daemonset churn → the ds-pod table).
  Leases and PDBs never journal (their appliers don't ``_note``), so
  they ride EVERY delta as small full tables — polling refresh is the
  only correct channel for them.
- :class:`StandbyReplica` (standby side) applies snapshots/deltas behind
  its own ``ClusterState`` through the same watch-stream appliers
  StateSync uses, and runs the cutover ladder: fresh anchor → delta
  catch-up; anchor outside the leader's journal window → ``full: true``
  comes back (``stale-anchor``) and the standby re-snapshots in the same
  poll — the delta solve path's always-correct fallback, verbatim; a
  snapshot version this standby does not speak → refuse and keep the
  held state (``snapshot-version-mismatch``) — a half-understood
  snapshot is worse than a stale one.

Transport is the solver sidecar's family (parallel/sidecar.py): unary
gRPC over this package's own wire (parallel/rpc.py), raw-bytes JSON
bodies (no protoc codegen), ``unix:`` sockets for same-host pairs or
``host:port`` across DCN, every RPC deadline-bounded so a hung leader can
never wedge the standby's poll loop.

Methods:
- /karpenter.replication.v1.Replication/Snapshot — {} → versioned full doc
- /karpenter.replication.v1.Replication/Delta    — {since} → delta doc
- /karpenter.replication.v1.Replication/Health   — {} → {version, anchor}

Live nominations are deliberately EXCLUDED from the stream: they expire
on the leader's clock and self-clean on bind/delete; a promoted standby
simply re-nominates on its first pass.
"""

from __future__ import annotations

import json
from concurrent import futures
from typing import Callable, Dict, Optional

from ..apis import serde
from ..parallel import rpc
from ..solver.taxonomy import SNAPSHOT_VERSION_MISMATCH, STALE_ANCHOR, reason
from .cluster import _JOURNAL_MAX, ClusterState, DirtyJournalCoalescer

# bump when the snapshot/delta document shape changes incompatibly: a
# standby refuses (and counts) any document carrying a different version
SNAPSHOT_VERSION = 1

_SNAPSHOT = "/karpenter.replication.v1.Replication/Snapshot"
_DELTA = "/karpenter.replication.v1.Replication/Delta"
_HEALTH = "/karpenter.replication.v1.Replication/Health"

# deadlines: a delta is a short journal drain (bounded like the solve
# RPC's); a snapshot serializes the whole mirror, so it gets more rope;
# health answers from a counter read
DELTA_TIMEOUT_SECONDS = 2.0
SNAPSHOT_TIMEOUT_SECONDS = 10.0
HEALTH_TIMEOUT_SECONDS = 1.0


class ReplicationProtocolError(RuntimeError):
    """The leader ANSWERED, but not with a replication document (body
    failed to decode, or decoded to a non-object). Classifies like a
    transport failure at the poll site — counted, never raised out of
    the standby's sync loop."""


# ---- leader side ----------------------------------------------------------


class ReplicationSource:
    """Serves snapshot/delta documents over a ClusterState.

    Owns its own :class:`DirtyJournalCoalescer` anchored at the LAST
    REPLICATED revision (the provisioner's coalescer is anchored at the
    builder's — same journal, independent cursors). ``tick()`` may ride
    any leader-side poll loop to amortize the locked journal walk;
    ``delta_doc`` stays correct without it (``take`` falls back to a
    direct ``dirty_since``).
    """

    def __init__(self, cluster: ClusterState):
        from ..introspect import contention
        self._cluster = cluster
        self._coalescer = DirtyJournalCoalescer(cluster)
        # serializes delta drains: gRPC workers may overlap polls and the
        # coalescer is single-owner by contract
        self._lock = contention.lock("replication")
        self._last_rev = -1
        # observability (the handoff introspection provider folds these)
        self.snapshots = 0
        self.deltas = 0
        self.full_answers = 0

    def anchor(self) -> int:
        return self._cluster.state_rev

    def tick(self) -> None:
        """Drain the journal incrementally toward the next delta poll."""
        with self._lock:
            if self._last_rev >= 0:
                self._coalescer.tick(self._last_rev)

    def headroom_probe(self) -> Dict[str, float]:
        """Replication window (introspect/headroom.py): revisions the
        standby has not acknowledged yet. Exhausting the journal window
        forces a ``full: true`` delta → standby re-snapshot — counted by
        the pre-existing ``full_answers``."""
        with self._lock:
            last = self._last_rev
        window = (self._cluster.state_rev - last) if last >= 0 else 0
        return {"depth": float(max(window, 0)),
                "capacity": float(_JOURNAL_MAX),
                "drops": float(self.full_answers)}

    def snapshot_doc(self) -> Dict:
        """The whole mirror under ONE lock hold, anchored at the revision
        the cut was taken at — the delta stream continues exactly here."""
        c = self._cluster
        with c._lock:
            doc = {
                "version": SNAPSHOT_VERSION,
                "anchor": c.state_rev,
                "pods": [serde.pod_to_dict(p)
                         for _, p in sorted(c.pods.items())],
                "nodes": [serde.node_to_dict(n)
                          for _, n in sorted(c.nodes.items())],
                "claims": [serde.nodeclaim_to_dict(cl)
                           for _, cl in sorted(c.claims.items())],
                "pvcs": [serde.pvc_to_dict(v)
                         for _, v in sorted(c.pvcs.items())],
                "storageClasses": [serde.storage_class_to_dict(s)
                                   for _, s in sorted(c.storage_classes.items())],
                "leases": [serde.lease_to_dict(l)
                           for _, l in sorted(c.leases.items())],
                "pdbs": [serde.pdb_to_dict(p)
                         for _, p in sorted(c.pdbs.items())],
            }
        self.snapshots += 1
        self._last_rev = doc["anchor"]
        return doc

    def delta_doc(self, since: int) -> Dict:
        """What changed in (``since``, now], as applicable documents.
        ``full: true`` when the journal cannot answer (anchor outside the
        ring, or from another life of the mirror) — the standby's cue to
        re-snapshot."""
        with self._lock:
            ds = self._coalescer.take(int(since))
            self._last_rev = ds.rev
        doc: Dict = {"version": SNAPSHOT_VERSION, "since": ds.since,
                     "anchor": ds.rev, "ticks": ds.ticks}
        self.deltas += 1
        if ds.full:
            doc["full"] = True
            self.full_answers += 1
            return doc
        c = self._cluster
        with c._lock:
            pods = []
            for name in sorted(ds.pods):
                p = c.pods.get(name)
                pods.append({"name": name, "deleted": True} if p is None
                            else serde.pod_to_dict(p))
            doc["pods"] = pods
            if ds.daemonsets:
                doc["daemonsetPods"] = [
                    serde.pod_to_dict(p) for _, p in sorted(c.pods.items())
                    if p.is_daemonset]
            if ds.bins or ds.other:
                doc["nodes"] = [serde.node_to_dict(n)
                                for _, n in sorted(c.nodes.items())]
                doc["claims"] = [serde.nodeclaim_to_dict(cl)
                                 for _, cl in sorted(c.claims.items())]
            if ds.volumes or ds.other:
                doc["pvcs"] = [serde.pvc_to_dict(v)
                               for _, v in sorted(c.pvcs.items())]
                doc["storageClasses"] = [
                    serde.storage_class_to_dict(s)
                    for _, s in sorted(c.storage_classes.items())]
            # leases and PDBs never journal: small tables, every delta
            doc["leases"] = [serde.lease_to_dict(l)
                             for _, l in sorted(c.leases.items())]
            doc["pdbs"] = [serde.pdb_to_dict(p)
                           for _, p in sorted(c.pdbs.items())]
        return doc

    def stats(self) -> Dict[str, int]:
        return {"snapshots": self.snapshots, "deltas": self.deltas,
                "full_answers": self.full_answers,
                "anchor": self.anchor()}


class ReplicationService:
    """Raw-bytes request handling around a ReplicationSource (the
    sidecar's SolverService shape: payload bytes in, JSON bytes out)."""

    def __init__(self, source: ReplicationSource):
        self._source = source

    def snapshot(self, payload: bytes) -> bytes:
        return json.dumps(self._source.snapshot_doc()).encode()

    def delta(self, payload: bytes) -> bytes:
        req = json.loads(payload.decode()) if payload else {}
        return json.dumps(
            self._source.delta_doc(int(req.get("since", -1)))).encode()

    def health(self, payload: bytes) -> bytes:
        return json.dumps({"version": SNAPSHOT_VERSION,
                           "anchor": self._source.anchor()}).encode()


class _Handler(rpc.GenericRpcHandler):
    def __init__(self, service: ReplicationService):
        self._service = service

    def service(self, handler_call_details):
        m = handler_call_details.method
        if m == _SNAPSHOT:
            return rpc.unary_unary_rpc_method_handler(
                lambda req, ctx: self._service.snapshot(req))
        if m == _DELTA:
            return rpc.unary_unary_rpc_method_handler(
                lambda req, ctx: self._service.delta(req))
        if m == _HEALTH:
            return rpc.unary_unary_rpc_method_handler(
                lambda req, ctx: self._service.health(req))
        return None


def serve_replication(service: ReplicationService, address: str,
                      max_workers: int = 2):
    """Start a replication server on ``address`` (``unix:`` or
    ``host:port``); returns the started rpc.Server."""
    server = rpc.server(futures.ThreadPoolExecutor(max_workers=max_workers))
    server.add_generic_rpc_handlers((_Handler(service),))
    # unix sockets return 1 on success; 0 means the bind failed
    if server.add_insecure_port(address) == 0:
        raise RuntimeError(
            f"replication server failed to bind {address!r}")
    server.start()
    return server


# ---- standby side ---------------------------------------------------------


class ReplicationClient:
    """Deadline-bounded unary JSON client (the SolverClient idiom)."""

    def __init__(self, address: str,
                 timeout: float = DELTA_TIMEOUT_SECONDS,
                 snapshot_timeout: float = SNAPSHOT_TIMEOUT_SECONDS,
                 health_timeout: float = HEALTH_TIMEOUT_SECONDS):
        self.address = address
        self.timeout = timeout
        self.snapshot_timeout = snapshot_timeout
        self.health_timeout = health_timeout
        # tight reconnect backoff: a restarted leader should be found in
        # ~250-500 ms, not gRPC's default exponential crawl
        self._channel = rpc.insecure_channel(address, options=[
            ("grpc.initial_reconnect_backoff_ms", 250),
            ("grpc.min_reconnect_backoff_ms", 250),
            ("grpc.max_reconnect_backoff_ms", 500),
        ])
        self._snapshot = self._channel.unary_unary(_SNAPSHOT)
        self._delta = self._channel.unary_unary(_DELTA)
        self._health = self._channel.unary_unary(_HEALTH)

    def _call(self, fn, req: Dict, timeout: float) -> Dict:
        resp = fn(json.dumps(req).encode(), timeout=timeout)
        try:
            doc = json.loads(resp.decode())
            if not isinstance(doc, dict):
                raise ValueError("non-object body")
        except (ValueError, UnicodeDecodeError) as e:
            raise ReplicationProtocolError(
                f"undecodable replication body from {self.address}: {e}")
        return doc

    def snapshot(self) -> Dict:
        return self._call(self._snapshot, {}, self.snapshot_timeout)

    def delta(self, since: int) -> Dict:
        return self._call(self._delta, {"since": int(since)}, self.timeout)

    def health(self) -> Dict:
        resp = self._health(b"{}", timeout=self.health_timeout,
                            wait_for_ready=True)
        try:
            doc = json.loads(resp.decode())
            if not isinstance(doc, dict):
                raise ValueError("non-object body")
        except (ValueError, UnicodeDecodeError) as e:
            raise ReplicationProtocolError(
                f"undecodable health body from {self.address}: {e}")
        return doc

    def close(self) -> None:
        self._channel.close()


class StandbyReplica:
    """Applies the replication stream behind the standby's own
    ClusterState and answers the bounded-staleness promotion gate.

    ``prebuild`` (optional zero-arg callable, typically the standby
    provisioner's ``warm_build``) runs after every successful sync so
    the resident device problem and the persistent compile cache stay
    warm — the first post-promotion pass starts from a delta, not a
    compile storm.
    """

    def __init__(self, cluster: ClusterState, client: ReplicationClient,
                 prebuild: Optional[Callable[[], object]] = None):
        self.cluster = cluster
        self.client = client
        self._prebuild = prebuild
        # the leader state_rev this mirror has applied through; -1 = no
        # snapshot held (a delta cannot be asked for)
        self.anchor = -1
        self.last_reason = ""
        self.last_error = ""
        self.snapshots = 0
        self.deltas = 0
        self.delta_pods = 0
        self.stale_anchor_rebuilds = 0
        self.version_mismatch_rebuilds = 0
        self.stale_promotions = 0
        self.promotions_blocked = 0
        self.poll_errors = 0
        self.prebuilds = 0
        self.prebuild_errors = 0

    # ---- appliers ---------------------------------------------------------

    def _apply_snapshot(self, doc: Dict) -> bool:
        if doc.get("version") != SNAPSHOT_VERSION:
            self.version_mismatch_rebuilds += 1
            self.last_reason = reason(
                SNAPSHOT_VERSION_MISMATCH,
                f"leader speaks v{doc.get('version')}, "
                f"standby v{SNAPSHOT_VERSION}")
            return False
        c = self.cluster
        c.reset()
        # StorageClasses before PVCs (add_pvc's Immediate-binding pin
        # consults them), nodes/claims before pods (bind side effects)
        for d in doc.get("storageClasses", ()):
            c.add_storage_class(serde.storage_class_from_dict(d))
        for d in doc.get("pvcs", ()):
            c.add_pvc(serde.pvc_from_dict(d))
        for d in doc.get("nodes", ()):
            c.add_node(serde.node_from_dict(d))
        for d in doc.get("claims", ()):
            c.add_claim(serde.nodeclaim_from_dict(d))
        for d in doc.get("pods", ()):
            c.add_pod(serde.pod_from_dict(d))
        for d in doc.get("leases", ()):
            c.add_lease(serde.lease_from_dict(d))
        for d in doc.get("pdbs", ()):
            c.add_pdb(serde.pdb_from_dict(d))
        self.anchor = int(doc["anchor"])
        self.snapshots += 1
        self.last_reason = ""
        return True

    def _reconcile(self, docs, from_dict, current, apply_one, delete_one):
        """Table refresh: apply every incoming object, delete mirror
        entries the table no longer carries."""
        names = set()
        for d in docs:
            obj = from_dict(d)
            names.add(obj.name)
            apply_one(obj)
        for gone in set(current()) - names:
            delete_one(gone)

    def _apply_delta(self, doc: Dict) -> bool:
        if doc.get("version") != SNAPSHOT_VERSION:
            self.version_mismatch_rebuilds += 1
            self.last_reason = reason(
                SNAPSHOT_VERSION_MISMATCH,
                f"leader speaks v{doc.get('version')}, "
                f"standby v{SNAPSHOT_VERSION}")
            return False
        if doc.get("full"):
            # the anchor fell out of the leader's journal window (or the
            # leader's mirror lived another life): re-snapshot — the
            # delta path's always-correct fallback
            self.stale_anchor_rebuilds += 1
            self.last_reason = reason(
                STALE_ANCHOR,
                f"anchor {self.anchor} outside the leader's journal window")
            self.anchor = -1
            return False
        c = self.cluster
        for d in doc.get("pods", ()):
            if d.get("deleted"):
                c.delete_pod(d["name"])
            else:
                c.apply_pod_spec(serde.pod_from_dict(d))
            self.delta_pods += 1
        if "daemonsetPods" in doc:
            names = set()
            for d in doc["daemonsetPods"]:
                p = serde.pod_from_dict(d)
                names.add(p.name)
                c.apply_pod_spec(p)
            for p in c.daemonset_pods():
                if p.name not in names:
                    c.delete_pod(p.name)
        if "nodes" in doc:
            self._reconcile(doc["nodes"], serde.node_from_dict,
                            lambda: list(c.nodes), c.apply_node,
                            c.delete_node)
        if "claims" in doc:
            self._reconcile(doc["claims"], serde.nodeclaim_from_dict,
                            lambda: list(c.claims), c.apply_claim,
                            c.delete_claim)
        if "storageClasses" in doc:
            self._reconcile(doc["storageClasses"],
                            serde.storage_class_from_dict,
                            lambda: list(c.storage_classes),
                            c.add_storage_class, c.delete_storage_class)
        if "pvcs" in doc:
            self._reconcile(doc["pvcs"], serde.pvc_from_dict,
                            lambda: list(c.pvcs), c.apply_pvc, c.delete_pvc)
        self._reconcile(doc.get("leases", ()), serde.lease_from_dict,
                        lambda: list(c.leases), c.add_lease, c.delete_lease)
        self._reconcile(doc.get("pdbs", ()), serde.pdb_from_dict,
                        lambda: list(c.pdbs), c.add_pdb, c.delete_pdb)
        self.anchor = int(doc["anchor"])
        self.deltas += 1
        self.last_reason = ""
        return True

    # ---- the poll loop ----------------------------------------------------

    def sync_once(self) -> bool:
        """One replication poll: snapshot when cold, delta otherwise; a
        stale-anchor answer re-snapshots IN THE SAME POLL. Never raises —
        transport failures count and the next poll retries."""
        try:
            if self.anchor < 0:
                ok = self._apply_snapshot(self.client.snapshot())
            else:
                ok = self._apply_delta(self.client.delta(self.anchor))
                if not ok and self.anchor < 0:
                    ok = self._apply_snapshot(self.client.snapshot())
        except Exception as e:  # noqa: BLE001 — the poll loop must survive
            self.poll_errors += 1
            self.last_error = f"{type(e).__name__}: {e}"
            return False
        if ok and self._prebuild is not None:
            try:
                self._prebuild()
                self.prebuilds += 1
            except Exception as e:  # noqa: BLE001 — warmth is best-effort
                self.prebuild_errors += 1
                self.last_error = f"prebuild: {type(e).__name__}: {e}"
        return ok

    def promotion_ready(self) -> bool:
        """The bounded-staleness promotion gate (wired as the elector's
        ``promotion_gate``): one last-chance sync against the (possibly
        dead) leader. Fresh sync → promote on caught-up state; leader
        unreachable but a snapshot held → promote STALE (the first pass
        full-rebuilds — always correct, just not warm); no snapshot ever
        applied → refuse, promoting an empty mirror would read every
        live node as an orphan."""
        if self.sync_once():
            return True
        if self.anchor >= 0:
            self.stale_promotions += 1
            return True
        self.promotions_blocked += 1
        self.last_reason = "no snapshot applied yet; refusing promotion"
        return False

    def stats(self) -> Dict[str, object]:
        return {
            "anchor": self.anchor,
            "snapshots": self.snapshots,
            "deltas": self.deltas,
            "delta_pods": self.delta_pods,
            "stale_anchor_rebuilds": self.stale_anchor_rebuilds,
            "version_mismatch_rebuilds": self.version_mismatch_rebuilds,
            "stale_promotions": self.stale_promotions,
            "promotions_blocked": self.promotions_blocked,
            "poll_errors": self.poll_errors,
            "prebuilds": self.prebuilds,
            "prebuild_errors": self.prebuild_errors,
            "last_reason": self.last_reason,
            "last_error": self.last_error,
        }
