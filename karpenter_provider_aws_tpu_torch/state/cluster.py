"""In-memory cluster state.

The port of the JAX package's ``state/cluster.py``, whole: the mirror of
the core's cluster-state component (reference cmd/controller/main.go:50
`state.NewCluster`): a thread-safe mirror of pods, nodes, and NodeClaims
that is the solver's input source — it renders registered nodes and
in-flight claims into ``ExistingBin`` rows and bound pods into
``BoundPod`` topology accounting for build_problem.

Every mutation that can change the next provisioning pass's problem
appends one entry to the dirty journal; ``dirty_since`` answers with a
``DirtySet``, which the incremental problem builder
(solver/incremental.py) reads to patch the previous problem instead of
rebuilding it, and ``DirtyJournalCoalescer`` drains the journal between
passes so a pass starts from an already-merged set.

Nominations track pods the provisioner has assigned to a not-yet-registered
NodeClaim so the next scheduling pass neither double-schedules the pods nor
double-counts the headroom (the core nominates pods to in-flight nodes the
same way).
"""

from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from ..apis import wellknown as wk
from ..apis.objects import Node, NodeClaim, NodeClaimPhase, Pod
from ..apis.resources import R, axis, canonical_to_vec, resources_to_vec
from ..lattice.tensors import Lattice
from ..solver.problem import ExistingBin, csi_claims_count
from ..solver.topology import BoundPod
from ..utils.clock import Clock

NOMINATION_TTL = 20.0  # core nominates pods to in-flight capacity ~20s

_VOL_AXIS = axis("attachable-volumes")


@dataclass
class _Nomination:
    target: str            # NodeClaim name (or node name)
    expires: float


# dirty-journal entry kinds (see ClusterState.dirty_since): "pod" names a
# pod whose pending-relevance may have changed; "bin" marks any mutation
# that can move existing-bin rows (node/claim add/delete/refresh, binds);
# "volume" and "other" poison the incremental path entirely — PVC zone
# pins and untracked mutations have non-local effects on the problem.
_JOURNAL_MAX = 65536


@dataclass
class DirtySet:
    """What changed between two cluster-state revisions (the provisioner
    feeds this to solver/incremental.py). ``full`` means the journal
    could not answer (overflowed past ``since``) and the caller must
    rebuild from scratch — the always-correct fallback."""

    since: int
    rev: int
    full: bool = False
    pods: Set[str] = field(default_factory=set)   # names to re-examine
    bins: bool = False         # existing-bin inputs changed
    # node/claim names the bin mutations localized to, when the journal
    # entry carried one; ``bins_unnamed=True`` means at least one bin
    # mutation could NOT be localized, so per-name consumers must treat
    # the whole bin table as dirty — never a silently-partial answer
    bin_names: Set[str] = field(default_factory=set)
    bins_unnamed: bool = False
    volumes: bool = False      # PVC / StorageClass mutations
    daemonsets: bool = False   # daemonset pod set changed (ds_overhead)
    other: bool = False        # anything the journal cannot localize
    # journal drains merged into this set (DirtyJournalCoalescer): >1
    # means the controller fell behind and several batch-window ticks
    # were coalesced into one delta
    ticks: int = 1

    def merge(self, newer: "DirtySet") -> None:
        """Fold a LATER drain into this one. Valid only when ``newer``
        continues exactly where this set ends (newer.since == rev) — the
        coalescer guarantees it, so the merged set covers
        (self.since, newer.rev] with no gap."""
        if newer.since != self.rev:
            raise ValueError(f"non-contiguous journal drains: this set ends "
                             f"at {self.rev}, the newer starts at {newer.since}")
        self.rev = newer.rev
        self.full = self.full or newer.full
        self.pods |= newer.pods
        self.bins = self.bins or newer.bins
        self.bin_names |= newer.bin_names
        self.bins_unnamed = self.bins_unnamed or newer.bins_unnamed
        self.volumes = self.volumes or newer.volumes
        self.daemonsets = self.daemonsets or newer.daemonsets
        self.other = self.other or newer.other
        self.ticks += newer.ticks


class DirtyJournalCoalescer:
    """Streams the dirty journal into a pending device-block delta
    BETWEEN provisioning passes (docs/reference/microloop.md).

    ``dirty_since`` walks the journal tail under the cluster mirror's
    lock — the hottest lock in the process. A controller that falls
    behind (long batch window, slow pass) otherwise pays one long
    locked walk at pass start, exactly when latency matters most. The
    coalescer drains in small increments on every batch-window poll
    (:meth:`tick`) and merges the drains, so the pass itself picks up
    an already-coalesced set covering every journal tick since the
    last build (:meth:`take`) — one short drain instead of the whole
    backlog. An anchor mismatch (builder rebuilt at a different
    revision, another life of the mirror) falls back to a direct
    ``dirty_since`` — never a silently-partial answer.
    """

    def __init__(self, cluster: "ClusterState"):
        self._cluster = cluster
        self._merged: Optional[DirtySet] = None
        # observability: provisioner stats surface these
        self.ticks = 0
        self.takes = 0
        self.fallbacks = 0

    def tick(self, since: int) -> None:
        """Drain journal entries newer than what is already pending
        (anchored at ``since``, the incremental builder's revision)."""
        self.ticks += 1
        m = self._merged
        if m is not None and m.since == since:
            if m.rev != self._cluster.state_rev:
                m.merge(self._cluster.dirty_since(m.rev))
            return
        self._merged = self._cluster.dirty_since(since)

    def take(self, since: int) -> DirtySet:
        """The coalesced set covering (``since``, now] — consumed. Falls
        back to a direct journal read when the pending set is anchored
        elsewhere (or nothing was ticked)."""
        self.takes += 1
        m, self._merged = self._merged, None
        if m is None or m.since != since:
            if m is not None:
                self.fallbacks += 1
            return self._cluster.dirty_since(since)
        if m.rev != self._cluster.state_rev:
            # mutations landed after the last tick: top the set up so
            # the pass never builds against a stale horizon
            m.merge(self._cluster.dirty_since(m.rev))
        return m

    def headroom_probe(self) -> Dict[str, float]:
        """Undrained journal backlog (introspect/headroom.py): revisions
        landed since the pending set's horizon. It exhausts at
        _JOURNAL_MAX — a backlog older than the ring retains forces the
        full-rebuild fallback, the latency cliff the forecast exists to
        see coming. ``fallbacks`` is the pre-existing miss counter."""
        m = self._merged
        backlog = self._cluster.state_rev - (m.rev if m is not None
                                             else self._cluster.state_rev)
        return {"depth": float(max(backlog, 0)),
                "capacity": float(_JOURNAL_MAX),
                "drops": float(self.fallbacks)}


class ClusterState:
    def __init__(self, clock: Optional[Clock] = None):
        self._clock = clock or Clock()
        # instrumented (introspect/contention.py): the mirror's lock is
        # the most-acquired lock in the process — wait/hold accounting
        # shows when API-mode churn turns it into a convoy
        from ..introspect import contention
        self._lock = contention.rlock("cluster_state")
        self.pods: Dict[str, Pod] = {}
        self.nodes: Dict[str, Node] = {}
        self.claims: Dict[str, NodeClaim] = {}
        self.pvcs: Dict[str, "PersistentVolumeClaim"] = {}
        self.leases: Dict[str, "Lease"] = {}   # kube-node-lease mirror
        self.storage_classes: Dict[str, "StorageClass"] = {}
        self.pdbs: Dict[str, "PodDisruptionBudget"] = {}
        self._nominations: Dict[str, _Nomination] = {}   # pod -> claim
        self._pod_added: Dict[str, float] = {}           # pod -> arrival ts
        self._startup_samples: List[float] = []          # unbilled durations
        # bumps on node/claim add/delete AND on in-place state flips that
        # change committed capacity (touch_capacity — e.g. a claim marked
        # TERMINATING leaves pool_usage immediately); gauge emitters
        # re-render on a rev change instead of rebuilding vectors per pass
        self.capacity_rev = 0
        # the per-pass dirty journal (docs/concepts/performance.md
        # "Steady-state reconciles"): every mutation that can change the
        # next provisioning pass's problem appends one (rev, kind, name)
        # entry, so the incremental problem builder re-examines only what
        # actually moved since the revision it last built at. Entries
        # carry CONSECUTIVE revisions; a reader asking further back than
        # the ring retains gets DirtySet(full=True) — the always-correct
        # rebuild path, never a silently-partial answer.
        self.state_rev = 0
        self._journal: Deque[Tuple[int, str, str]] = deque(maxlen=_JOURNAL_MAX)
        # leases GC'd by sweep_orphaned_leases (promotion wires it in)
        self.leases_swept = 0

    # ---- dirty journal ----------------------------------------------------

    def _note(self, kind: str, name: str = "") -> None:
        """Append one journal entry (caller holds the lock)."""
        self.state_rev += 1
        self._journal.append((self.state_rev, kind, name))

    def headroom_probe(self) -> Dict[str, float]:
        """The dirty-journal ring itself (introspect/headroom.py).
        ``kind="ring"``: sitting full is its retention policy, not data
        loss — readers that fall off the tail get the full-rebuild
        answer, which the coalescer probe's queue-kind row forecasts."""
        return {"depth": float(len(self._journal)),
                "capacity": float(_JOURNAL_MAX),
                "kind": "ring"}

    def dirty_since(self, since: int) -> DirtySet:
        """What changed in (``since``, ``state_rev``]. ``full=True`` when
        the journal cannot answer (ring overflowed past ``since``, or
        ``since`` is from another life of this mirror). Pods with LIVE
        nominations are always included: a nomination expiring between
        passes re-pends its pod with no mutation to journal."""
        with self._lock:
            rev = self.state_rev
            out = DirtySet(since=since, rev=rev)
            if since > rev or since < rev - len(self._journal):
                out.full = True
                return out
            for erev, kind, name in reversed(self._journal):
                if erev <= since:
                    break
                if kind == "pod":
                    out.pods.add(name)
                elif kind == "bin":
                    out.bins = True
                    if name:
                        out.bin_names.add(name)
                    else:
                        out.bins_unnamed = True
                elif kind == "volume":
                    out.volumes = True
                elif kind == "dspod":
                    out.daemonsets = True
                else:
                    out.other = True
            # nominations expire on the clock, silently re-pending their
            # pods — treat every nominated pod as touched (the set is
            # small and self-cleans on bind/delete), and their usage on
            # unregistered claims' bins as movable
            if self._nominations:
                out.pods.update(self._nominations.keys())
                out.bins = True
                out.bin_names.update(n.target
                                     for n in self._nominations.values())
            return out

    def touched_pods(self, names) -> Dict[str, Tuple[str, Optional[Pod]]]:
        """Classify journal-touched pods for the incremental problem
        builder: name -> (state, pod) with state one of "pending" (pod is
        schedulable input right now), "gone", "bound", "nominated",
        "deleting", "daemonset". One lock hold for the whole set."""
        now = self._clock.now()
        out: Dict[str, Tuple[str, Optional[Pod]]] = {}
        with self._lock:
            for n in names:
                pod = self.pods.get(n)
                if pod is None:
                    out[n] = ("gone", None)
                elif pod.is_daemonset:
                    out[n] = ("daemonset", pod)
                elif pod.node_name is not None:
                    out[n] = ("bound", pod)
                elif pod.deletion_timestamp:
                    out[n] = ("deleting", pod)
                else:
                    nom = self._nominations.get(n)
                    if nom is not None and nom.expires > now:
                        out[n] = ("nominated", pod)
                    else:
                        out[n] = ("pending", pod)
        return out

    # ---- pods ------------------------------------------------------------

    def add_pod(self, pod: Pod) -> None:
        with self._lock:
            self.pods[pod.name] = pod
            self._note("dspod" if pod.is_daemonset else "pod", pod.name)
            if pod.node_name is not None:
                # first seen ALREADY BOUND (sync relist, external
                # scheduler): its node's used vector just grew
                self._note("bin", pod.node_name)
            # arrival stamp for the pods_startup_time metric (reference
            # karpenter_pods_startup_time_seconds: created → scheduled).
            # Already-bound pods (operator resync) are NOT arrivals — a
            # later evict+rebind of one must not emit a bogus multi-hour
            # "startup" measured from sync time
            if pod.node_name is None:
                self._pod_added.setdefault(pod.name, self._clock.now())

    def delete_pod(self, name: str) -> None:
        with self._lock:
            pod = self.pods.pop(name, None)
            self._nominations.pop(name, None)
            self._pod_added.pop(name, None)
            self._note("dspod" if pod is not None and pod.is_daemonset
                       else "pod", name)
            if pod is not None and pod.node_name is not None:
                # a bound pod leaving frees its node's used vector
                self._note("bin", pod.node_name)

    def drain_startup_samples(self) -> List[float]:
        """Newly-observed pod startup latencies (arrival → first bind)
        since the last call; the metrics loop feeds them to the
        karpenter_pods_startup_time_seconds histogram."""
        with self._lock:
            out, self._startup_samples = self._startup_samples, []
            return out

    def bind_pod(self, pod_name: str, node_name: str) -> None:
        with self._lock:
            pod = self.pods.get(pod_name)
            if pod is not None:
                # a bind changes BOTH the pending set and the target
                # bin's used vector
                self._note("pod", pod_name)
                self._note("bin", node_name)
                if pod.node_name is None:
                    added = self._pod_added.pop(pod_name, None)
                    if added is not None:
                        # first bind since arrival: startup latency sample
                        # (re-binds after eviction are not pod startups)
                        self._startup_samples.append(
                            max(self._clock.now() - added, 0.0))
                pod.node_name = node_name
                # WaitForFirstConsumer: the CSI driver creates the PV in the
                # zone the pod lands in; later consumers of the claim are
                # pinned there (reference scheduling.md:389-398)
                if pod.volume_claims:
                    node = self.nodes.get(node_name)
                    zone = node.labels.get(wk.LABEL_ZONE) if node else None
                    if zone:
                        for c in pod.volume_claims:
                            pvc = self.pvcs.get(c)
                            if pvc is not None and pvc.bound_zone is None:
                                pvc.bound_zone = zone
            self._nominations.pop(pod_name, None)

    # ---- volumes ---------------------------------------------------------

    def bind_volumes(self, pod_name: str, zone: Optional[str]) -> None:
        """Bind the pod's unbound claims to ``zone``. Called as soon as the
        pod's target zone is knowable — at launch success for nominated
        pods, at bind for pods landing on registered nodes — so a claim
        shared across batches converges on one zone even while the first
        consumer's node is still registering."""
        if not zone:
            return
        with self._lock:
            pod = self.pods.get(pod_name)
            if pod is None:
                return
            if pod.volume_claims:
                self._note("volume")
            for c in pod.volume_claims:
                pvc = self.pvcs.get(c)
                if pvc is not None and pvc.bound_zone is None:
                    pvc.bound_zone = zone

    def add_storage_class(self, sc) -> None:
        with self._lock:
            self.storage_classes[sc.name] = sc
            self._note("volume")

    def add_pvc(self, pvc) -> None:
        with self._lock:
            if pvc.bound_zone is None:
                sc = self.storage_classes.get(pvc.storage_class)
                if sc is not None and sc.binding_mode == "Immediate" and sc.zones:
                    # Immediate binding provisions the PV before any pod
                    # exists: the claim pins a zone now and consumers follow
                    # it (the inverse of WaitForFirstConsumer)
                    pvc.bound_zone = sc.zones[0]
            self.pvcs[pvc.name] = pvc
            self._note("volume")

    def volume_state(self):
        """Locked snapshot of (pvcs, storage_classes) for one solve: the
        solver must not observe bind_pod mutating bound_zone mid-round."""
        import dataclasses
        with self._lock:
            return ({k: dataclasses.replace(v) for k, v in self.pvcs.items()},
                    dict(self.storage_classes))

    def unbind_pods_on(self, node_name: str) -> List[Pod]:
        """Eviction: pods on the node become pending again (termination drain)."""
        with self._lock:
            out = []
            for pod in self.pods.values():
                if pod.node_name == node_name:
                    pod.node_name = None
                    self._note("pod", pod.name)
                    out.append(pod)
            if out:
                self._note("bin", node_name)
            return out

    # ---- node leases (kube-node-lease mirror) -----------------------------

    def add_lease(self, lease) -> None:
        with self._lock:
            self.leases[lease.name] = lease

    def delete_lease(self, name: str) -> None:
        with self._lock:
            self.leases.pop(name, None)

    def orphaned_leases(self) -> List[str]:
        """Leases with no owner reference, or whose owner node is gone —
        the lease GC sweep's input (reference core GCs ownerless
        kube-node-lease Leases; integration/lease_garbagecollection_test)."""
        with self._lock:
            return [l.name for l in self.leases.values()
                    if l.owner_node is None or l.owner_node not in self.nodes]

    def sweep_orphaned_leases(self, delete) -> int:
        """GC every orphaned lease through ``delete(name)`` (the writer's
        delete_lease verb), counting the sweep in :meth:`stats`. A newly
        promoted leader runs this once: holders that died during the
        blackout window left leases the periodic GC would only catch on
        its long interval."""
        names = self.orphaned_leases()
        for name in names:
            delete(name)
        with self._lock:
            self.leases_swept += len(names)
        return len(names)

    # ---- PodDisruptionBudgets ---------------------------------------------

    def add_pdb(self, pdb) -> None:
        with self._lock:
            self.pdbs[pdb.name] = pdb

    def delete_pdb(self, name: str) -> None:
        with self._lock:
            self.pdbs.pop(name, None)

    def _pdb_allowance(self, pdb) -> int:
        """Voluntary evictions the budget currently permits (the
        disruptions-allowed math of policy/v1): healthy = bound matching
        pods; desired = all matching pods (our controller-replica
        analog). Caller holds the lock."""
        matching = [p for p in self.pods.values()
                    if not p.is_daemonset and pdb.matches(p)]
        healthy = sum(1 for p in matching
                      if p.node_name is not None and not p.deletion_timestamp)
        allowed = len(matching)
        if pdb.min_available is not None:
            allowed = min(allowed, healthy - int(pdb.min_available))
        if pdb.max_unavailable is not None:
            unavailable = len(matching) - healthy
            allowed = min(allowed,
                          int(pdb.max_unavailable) - unavailable)
        return max(allowed, 0)

    def zero_allowance_pdbs(self) -> List["PodDisruptionBudget"]:
        """The budgets that currently permit no eviction. Allowance is
        node-independent, so candidate scans compute this ONCE per pass
        (one O(pdbs × pods) sweep) and match per-node pods against only
        this set."""
        with self._lock:
            return [pdb for pdb in self.pdbs.values()
                    if self._pdb_allowance(pdb) <= 0]

    def pdb_blockers(self, pods: List[Pod],
                     zero_pdbs: Optional[List["PodDisruptionBudget"]] = None,
                     ) -> Dict[str, str]:
        """pod name → name of a matching PDB with zero allowance right now
        (the reference's `pdb ... prevents pod evictions` condition,
        disruption.md:112). Pass ``zero_pdbs`` (from zero_allowance_pdbs)
        when checking many nodes in one pass."""
        if zero_pdbs is None:
            zero_pdbs = self.zero_allowance_pdbs()
        blocked: Dict[str, str] = {}
        for pdb in zero_pdbs:
            for p in pods:
                if not p.is_daemonset and pdb.matches(p):
                    blocked.setdefault(p.name, pdb.name)
        return blocked

    def evict_node(self, node_name: str) -> List[Pod]:
        """Final node teardown: every remaining pod unbinds, DAEMONSET
        pods are deleted outright (their controller stamps a fresh one on
        the next node; an unbound daemonset pod would live forever as
        phantom overhead in every future node sizing), and the node object
        goes. Returns the evicted non-daemonset pods."""
        evicted = []
        for pod in self.unbind_pods_on(node_name):
            if pod.is_daemonset:
                self.delete_pod(pod.name)
            else:
                evicted.append(pod)
        self.delete_node(node_name)
        return evicted

    def drain_node(self, node_name: str) -> Tuple[List[Pod], List[Pod]]:
        """PDB-respecting eviction pass over a cordoned node (reference
        disruption.md:33: evict via the Eviction API, wait for the node to
        fully drain before terminating). Returns (evicted, still_blocked);
        daemonset pods are ignored — they leave with the node. Each
        eviction decrements its budgets' live allowance, so one pass
        evicts at most what every matching budget permits and the rest
        waits for rescheduled pods to report healthy again."""
        with self._lock:
            allowance = {name: self._pdb_allowance(pdb)
                         for name, pdb in self.pdbs.items()}
            evicted: List[Pod] = []
            blocked: List[Pod] = []
            for pod in self.pods.values():
                if pod.node_name != node_name or pod.is_daemonset:
                    continue
                holders = [n for n, pdb in self.pdbs.items()
                           if pdb.matches(pod)]
                if all(allowance[n] > 0 for n in holders):
                    for n in holders:
                        allowance[n] -= 1
                    pod.node_name = None
                    self._note("pod", pod.name)
                    self._note("bin", node_name)
                    evicted.append(pod)
                else:
                    blocked.append(pod)
            return evicted, blocked

    def nominate(self, pod_name: str, target: str, ttl: float = NOMINATION_TTL) -> None:
        with self._lock:
            self._nominations[pod_name] = _Nomination(target, self._clock.now() + ttl)
            # nominated pods charge their unregistered claim's bin
            # (existing_bins sums nominated usage)
            self._note("pod", pod_name)
            self._note("bin", target)

    def nominated_pods(self, target: str) -> List[Pod]:
        now = self._clock.now()
        with self._lock:
            return [self.pods[p] for p, n in self._nominations.items()
                    if n.target == target and n.expires > now and p in self.pods]

    def pending_pods(self) -> List[Pod]:
        """Unbound, un-nominated, non-daemonset pods awaiting capacity."""
        now = self._clock.now()
        with self._lock:
            out = []
            for pod in self.pods.values():
                if pod.node_name is not None or pod.is_daemonset or pod.deletion_timestamp:
                    continue
                nom = self._nominations.get(pod.name)
                if nom is not None and nom.expires > now:
                    continue
                out.append(pod)
            return out

    def daemonset_pods(self) -> List[Pod]:
        with self._lock:
            return [p for p in self.pods.values() if p.is_daemonset]

    def pod_phase_counts(self) -> Dict[str, int]:
        """Every pod classified into exactly ONE phase — the
        karpenter_pods_state{phase} gauge surface: bound (on a node),
        deleting (unbound with a deletion timestamp), nominated (awaiting
        a pending claim's registration), pending (awaiting capacity)."""
        now = self._clock.now()
        counts = {"bound": 0, "pending": 0, "nominated": 0, "deleting": 0}
        with self._lock:
            for pod in self.pods.values():
                if pod.node_name is not None:
                    counts["bound"] += 1
                elif pod.deletion_timestamp:
                    counts["deleting"] += 1
                else:
                    nom = self._nominations.get(pod.name)
                    if nom is not None and nom.expires > now:
                        counts["nominated"] += 1
                    else:
                        counts["pending"] += 1
        return counts

    def stats(self) -> Dict[str, int]:
        """Introspection snapshot of the mirror (one lock hold, counter
        reads + one pod scan for the phase split)."""
        phases = self.pod_phase_counts()
        with self._lock:
            claims_deleting = sum(1 for c in self.claims.values()
                                  if c.deletion_timestamp)
            return {
                "pods": len(self.pods),
                "pods_bound": phases["bound"],
                "pods_pending": phases["pending"],
                "pods_nominated": phases["nominated"],
                "pods_deleting": phases["deleting"],
                "nodes": len(self.nodes),
                "claims": len(self.claims),
                "claims_deleting": claims_deleting,
                "pvcs": len(self.pvcs),
                "leases": len(self.leases),
                "leases_swept": self.leases_swept,
                "pdbs": len(self.pdbs),
                "capacity_rev": self.capacity_rev,
            }

    # ---- nodes / claims ---------------------------------------------------

    def touch_capacity(self, name: str = "") -> None:
        """Record an in-place mutation that changes pool_usage() without
        an add/delete (a claim marked for deletion, a node cordon that
        excludes it from capacity). ``name`` localizes the mutation to a
        node/claim for the dirty journal; "" poisons per-name consumers."""
        with self._lock:
            self.capacity_rev += 1
            self._note("bin", name)

    def add_node(self, node: Node) -> None:
        with self._lock:
            self.nodes[node.name] = node
            self.capacity_rev += 1
            self._note("bin", node.name)

    def delete_node(self, name: str) -> None:
        with self._lock:
            self.nodes.pop(name, None)
            self.capacity_rev += 1
            self._note("bin", name)

    def add_claim(self, claim: NodeClaim) -> None:
        with self._lock:
            self.claims[claim.name] = claim
            self.capacity_rev += 1
            self._note("bin", claim.name)

    def delete_claim(self, name: str) -> None:
        with self._lock:
            self.claims.pop(name, None)
            self.capacity_rev += 1
            self._note("bin", name)
            stale = [p for p, n in self._nominations.items() if n.target == name]
            for p in stale:
                del self._nominations[p]
                self._note("pod", p)

    def node_for_claim(self, claim_name: str) -> Optional[Node]:
        with self._lock:
            for node in self.nodes.values():
                if node.node_claim == claim_name:
                    return node
            return None

    def snapshot_claims(self) -> List[NodeClaim]:
        """Locked list copy — Python-level iteration over the raw dict can
        raise mid-loop if a concurrent controller mutates it."""
        with self._lock:
            return list(self.claims.values())

    def snapshot_pods(self) -> List[Pod]:
        with self._lock:
            return list(self.pods.values())

    def snapshot_nodes(self) -> List[Node]:
        with self._lock:
            return list(self.nodes.values())

    def nodes_by_claim(self) -> Dict[str, Node]:
        """Snapshot index claim name -> node (one pass instead of an
        O(nodes) node_for_claim scan per claim)."""
        with self._lock:
            return {n.node_claim: n for n in self.nodes.values()
                    if n.node_claim}

    def pods_by_node(self, include_daemonsets: bool = True) -> Dict[str, List[Pod]]:
        """Locked snapshot of the node -> bound pods index."""
        with self._lock:
            by_node = self._pods_by_node()
            if include_daemonsets:
                return by_node
            return {n: [p for p in ps if not p.is_daemonset]
                    for n, ps in by_node.items()}

    # ---- solver inputs ----------------------------------------------------

    def _pods_by_node(self) -> Dict[str, List[Pod]]:
        by_node: Dict[str, List[Pod]] = {}
        for pod in self.pods.values():
            if pod.node_name is not None:
                by_node.setdefault(pod.node_name, []).append(pod)
        return by_node

    def existing_bins(self, lattice: Lattice) -> List[ExistingBin]:
        """Registered nodes + launched-but-unregistered claims as packer bins."""
        with self._lock:
            by_node = self._pods_by_node()
            bins: List[ExistingBin] = []
            for node in self.nodes.values():
                itype = node.labels.get(wk.LABEL_INSTANCE_TYPE)
                zone = node.labels.get(wk.LABEL_ZONE)
                cap = node.labels.get(wk.LABEL_CAPACITY_TYPE, "on-demand")
                if itype not in lattice.name_to_idx or zone not in lattice.zones:
                    continue
                # a cordoned (disruption-tainted) or terminating node is
                # not schedulable capacity: offering it would bounce
                # drained pods straight back to the node being emptied
                if any(t.key == wk.DISRUPTION_TAINT_KEY for t in node.taints):
                    continue
                claim = self.claims.get(node.node_claim) if node.node_claim else None
                if claim is not None and claim.deletion_timestamp:
                    continue
                used = np.zeros((R,), np.float32)
                vol_claims: set = set()
                for pod in by_node.get(node.name, ()):
                    used += resources_to_vec(pod.requests, implicit_pod=True)
                    vol_claims.update(pod.volume_claims)
                if vol_claims:
                    # resident CSI volumes hold attach slots against the
                    # node's limit (reference troubleshooting.md:277-288);
                    # the set dedups pods sharing one claim — a volume
                    # attaches to the node once
                    used[_VOL_AXIS] += csi_claims_count(
                        vol_claims, self.pvcs, self.storage_classes)
                alloc_override = None
                if node.allocatable:
                    # node status resources are canonical-unit floats; NaN
                    # marks unreported axes so the solver falls back to the
                    # lattice prediction there (e.g. attachable-volumes
                    # before the CSINode registers)
                    alloc_override = canonical_to_vec(node.allocatable,
                                                      missing=np.nan)
                bins.append(ExistingBin(
                    name=node.name, node_pool=node.node_pool or "",
                    instance_type=itype, zone=zone, capacity_type=cap,
                    used=used, alloc_override=alloc_override,
                    labels=dict(node.labels)))
            registered = {n.node_claim for n in self.nodes.values() if n.node_claim}
            for claim in self.claims.values():
                if claim.name in registered or claim.deletion_timestamp:
                    continue
                if claim.phase not in (NodeClaimPhase.LAUNCHED,):
                    continue
                if claim.instance_type not in lattice.name_to_idx:
                    continue
                used = np.zeros((R,), np.float32)
                vol_claims = set()
                for pod in self.nominated_pods(claim.name):
                    used += resources_to_vec(pod.requests, implicit_pod=True)
                    vol_claims.update(pod.volume_claims)
                if vol_claims:
                    # nominated volume pods hold attach slots on the
                    # in-flight claim too, or a second pass before the
                    # CSINode registers over-packs it
                    used[_VOL_AXIS] += csi_claims_count(
                        vol_claims, self.pvcs, self.storage_classes)
                bins.append(ExistingBin(
                    name=claim.name, node_pool=claim.node_pool,
                    instance_type=claim.instance_type,
                    zone=claim.zone or lattice.zones[0],
                    capacity_type=claim.capacity_type or "on-demand",
                    used=used, labels=dict(claim.labels),
                    # an in-flight claim's allocatable (e.g. a kubelet
                    # maxPods clamp) binds exactly like a registered
                    # node's — omitting it let consolidation what-ifs
                    # overpack unregistered claims and churn forever
                    alloc_override=(canonical_to_vec(claim.allocatable)
                                    if claim.allocatable else None)))
            return bins

    def bound_pods(self) -> List[BoundPod]:
        with self._lock:
            out: List[BoundPod] = []
            for pod in self.pods.values():
                if pod.node_name is None:
                    continue
                node = self.nodes.get(pod.node_name)
                zone = node.labels.get(wk.LABEL_ZONE, "") if node else ""
                cap = node.labels.get(wk.LABEL_CAPACITY_TYPE, "on-demand") if node else "on-demand"
                out.append(BoundPod(pod=pod, node_name=pod.node_name, zone=zone,
                                    capacity_type=cap,
                                    node_labels=dict(node.labels) if node else {}))
            return out

    def pool_usage(self) -> Dict[str, np.ndarray]:
        """Per-NodePool committed capacity (registered nodes + in-flight
        claims) for NodePool limits enforcement (nodepools.md limits)."""
        with self._lock:
            usage: Dict[str, np.ndarray] = {}
            counted = set()
            for node in self.nodes.values():
                pool = node.node_pool
                if not pool:
                    continue
                vec = canonical_to_vec(node.capacity) if node.capacity else np.zeros((R,), np.float32)
                usage[pool] = usage.get(pool, np.zeros((R,), np.float32)) + vec
                if node.node_claim:
                    counted.add(node.node_claim)
            for claim in self.claims.values():
                if claim.name in counted or claim.deletion_timestamp:
                    continue
                if claim.phase in (NodeClaimPhase.TERMINATING, NodeClaimPhase.TERMINATED):
                    continue
                vec = canonical_to_vec(claim.capacity) if claim.capacity else np.zeros((R,), np.float32)
                usage[claim.node_pool] = usage.get(claim.node_pool, np.zeros((R,), np.float32)) + vec
            return usage

    # ---- watch-stream appliers (operator/sync.py StateSync) ---------------
    # The mirror as informer cache: these locked appliers replace whole
    # objects from watch events while routing state TRANSITIONS through
    # the same side-effecting paths the direct stratum uses (bind_pod's
    # startup samples + WaitForFirstConsumer pins, capacity_rev bumps).

    def apply_pod_spec(self, pod: Pod) -> None:
        with self._lock:
            existing = self.pods.get(pod.name)
            if existing is None:
                self.add_pod(pod)
                return
            old_node, new_node = existing.node_name, pod.node_name
            if old_node is None and new_node is not None:
                # install unbound, then bind — side effects fire exactly
                # as in the direct stratum
                pod.node_name = None
                self.pods[pod.name] = pod
                self.bind_pod(pod.name, new_node)
            else:
                self.pods[pod.name] = pod
                self._note("dspod" if pod.is_daemonset else "pod", pod.name)
                if new_node is not None or old_node is not None:
                    # a refresh of a bound pod can change its requests —
                    # its node's used vector moves with it
                    self._note("bin", new_node or old_node or "")
                    if old_node and new_node and old_node != new_node:
                        self._note("bin", old_node)

    def apply_node(self, node: Node) -> None:
        with self._lock:
            if node.name in self.nodes:
                # in-place refresh (e.g. a cordon taint) can flip capacity
                # semantics without an add/delete
                self.nodes[node.name] = node
                self.capacity_rev += 1
                self._note("bin", node.name)
            else:
                self.add_node(node)

    def apply_claim(self, claim: NodeClaim) -> None:
        with self._lock:
            prev = self.claims.get(claim.name)
            if prev is None:
                self.add_claim(claim)
                return
            self.claims[claim.name] = claim
            self._note("bin", claim.name)
            if (bool(prev.deletion_timestamp) != bool(claim.deletion_timestamp)
                    or prev.phase != claim.phase):
                # deletion stamp / phase flips change pool_usage() without
                # an add/delete
                self.capacity_rev += 1

    def delete_pvc(self, name: str) -> None:
        with self._lock:
            self.pvcs.pop(name, None)
            self._note("volume")

    def delete_storage_class(self, name: str) -> None:
        with self._lock:
            self.storage_classes.pop(name, None)
            self._note("volume")

    def apply_pvc(self, pvc) -> None:
        with self._lock:
            existing = self.pvcs.get(pvc.name)
            if existing is not None and existing.bound_zone and not pvc.bound_zone:
                # the mirror may have fast-forwarded a WaitForFirstConsumer
                # pin before the server write landed — never regress it
                pvc.bound_zone = existing.bound_zone
            self.add_pvc(pvc)

    def reset(self) -> None:
        with self._lock:
            self.pods.clear()
            self.nodes.clear()
            self.claims.clear()
            self.pvcs.clear()
            self.leases.clear()
            self.storage_classes.clear()
            self.pdbs.clear()
            self._nominations.clear()
            self._pod_added.clear()
            self._startup_samples.clear()
            # a reset is another life of the mirror: drop the journal and
            # advance the revision so any held revision reads as stale
            self._journal.clear()
            self.state_rev += 1
