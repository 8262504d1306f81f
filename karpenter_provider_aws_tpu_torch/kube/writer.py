"""The controllers' write seam: every Kubernetes-object mutation a
controller makes goes through this interface.

Two implementations, one contract:

- ``DirectWriter`` applies writes straight into the ClusterState mirror —
  the deterministic simulation stratum (FakeClock unit tests), where
  read-your-write is immediate.
- ``ApiWriter`` writes to the fake apiserver through the typed client;
  the mirror only changes when the operator's informers deliver the watch
  events (operator/sync.py). This is the reference's wiring: controllers
  own NO state — they act through the client and observe through caches
  (cmd/controller/main.go:47-53, operator.go:92-186).

The split keeps controller code identical across strata — the reference
achieves the same by running envtest (a real apiserver) under its unit
suites (pkg/test/environment.go:83-162).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

from .. import trace
from ..apis.objects import Lease, Node, NodeClaim, NodeClaimPhase, Pod
from ..state.cluster import ClusterState
from ..utils.clock import Clock
from .apiserver import (
    ConflictError, EvictionBlockedError, NotFoundError,
)
from .client import KubeClient


class FencedWriteError(RuntimeError):
    """A side-effectful write was attempted under a fencing token the
    lease store no longer carries — a demoted (zombie) leader's queued
    eviction/claim/bind. Raised AT THE VERB so the write never reaches
    the store; the controller runtime counts it like any reconcile error
    and the zombie's loop goes quiet instead of racing the new leader."""

    def __init__(self, verb: str, fence: int):
        # lazy: kube must stay importable without the solver package
        from ..solver.taxonomy import FENCED_WRITE_REJECTED, reason
        self.verb = verb
        self.fence = fence
        self.reason = reason(FENCED_WRITE_REJECTED,
                             f"{verb} under rotated fence (held {fence})")
        super().__init__(self.reason)


class WriterCounts:
    """Per-verb write-throughput counters shared by both writer
    implementations — the introspection registry's ``writer`` provider,
    and the input the round-5 verdict's write-path profiling item needs
    (API-stratum throughput DEGRADES 1k→15k; these counters put per-verb
    rates next to the apiserver's own watch/event stats)."""

    def _init_counts(self) -> None:
        self.counts: Dict[str, int] = {}
        # instrumented (introspect/contention.py): every write verb
        # passes through here — contention means the write path itself
        # is the serializer
        from ..introspect import contention
        self._counts_lock = contention.lock("writer")
        # handoff fencing (operator/leaderelection.py FenceGuard):
        # unarmed (None) in single-operator deployments — one attribute
        # read on the write path
        self._fence = None

    def set_fence(self, guard) -> None:
        """Arm handoff fencing: every side-effectful verb re-checks the
        lease store's fencing token first and raises
        :class:`FencedWriteError` (counted as ``fenced_reject``) when it
        rotated — the zombie-leader write barrier."""
        self._fence = guard

    def _check_fence(self, verb: str) -> None:
        g = self._fence
        if g is None or g.check():
            return
        self._count("fenced_reject")
        raise FencedWriteError(verb, g.fence)

    def _count(self, verb: str, n: int = 1) -> None:
        with self._counts_lock:
            self.counts[verb] = self.counts.get(verb, 0) + n

    def stats(self) -> Dict[str, int]:
        with self._counts_lock:
            return dict(self.counts)


class DirectWriter(WriterCounts):
    """Write-through to the ClusterState mirror (simulation stratum)."""

    def __init__(self, cluster: ClusterState, clock: Clock):
        self.cluster = cluster
        self.clock = clock
        self._init_counts()

    # ---- claims ------------------------------------------------------------

    def create_claim(self, claim: NodeClaim) -> None:
        self._check_fence("create_claim")
        self._count("create_claim")
        self.cluster.add_claim(claim)

    def update_claim_status(self, claim: NodeClaim) -> None:
        # in-place mutation is already visible through the mirror
        self._check_fence("update_claim_status")
        self._count("update_claim_status")

    def mark_claim_deleting(self, name: str) -> None:
        """The k8s delete that starts the finalizer/termination flow."""
        self._check_fence("mark_claim_deleting")
        self._count("mark_claim_deleting")
        claim = self.cluster.claims.get(name)
        if claim is None:
            return
        if not claim.deletion_timestamp:
            claim.deletion_timestamp = self.clock.now()
            claim.phase = NodeClaimPhase.TERMINATING
            # the claim leaves pool_usage() immediately: re-render gauges
            self.cluster.touch_capacity(name)

    def rollback_claim(self, name: str) -> None:
        """Hard delete of a claim whose instance never materialized (or is
        already gone) — no drain, no finalizer round."""
        self._check_fence("rollback_claim")
        self._count("rollback_claim")
        self.cluster.delete_claim(name)

    def finalize_claim(self, claim: NodeClaim) -> None:
        """Termination complete: remove the claim object."""
        self._check_fence("finalize_claim")
        self._count("finalize_claim")
        self.cluster.delete_claim(claim.name)

    # ---- nodes -------------------------------------------------------------

    def register_node(self, node: Node, lease: Optional[Lease] = None) -> None:
        self._check_fence("register_node")
        self._count("register_node")
        self.cluster.add_node(node)
        if lease is not None:
            self.cluster.add_lease(lease)

    def cordon(self, node: Node, taint) -> bool:
        self._check_fence("cordon")
        if all(t.key != taint.key for t in node.taints):
            self._count("cordon")
            node.taints.append(taint)
            return True
        return False

    def drain_node(self, node_name: str) -> Tuple[List[Pod], List[Pod]]:
        self._check_fence("drain_node")
        self._count("drain_node")
        return self.cluster.drain_node(node_name)

    def teardown_node(self, node_name: str) -> None:
        self._check_fence("teardown_node")
        self._count("teardown_node")
        self.cluster.evict_node(node_name)

    # ---- pods / volumes / leases ------------------------------------------

    def bind_pod(self, pod_name: str, node_name: str) -> bool:
        self._check_fence("bind_pod")
        self._count("bind_pod")
        self.cluster.bind_pod(pod_name, node_name)
        return True

    def bind_pods(self, pairs: Sequence[Tuple[str, str]]) -> List[bool]:
        """Batched bind: the mirror path has no lock to amortize, so it
        is the per-pod verb in a loop (same contract as ApiWriter's)."""
        return [self.bind_pod(p, n) for p, n in pairs]

    def bind_volumes(self, pod_name: str, zone: Optional[str]) -> None:
        self._check_fence("bind_volumes")
        self._count("bind_volumes")
        self.cluster.bind_volumes(pod_name, zone)

    def delete_lease(self, name: str) -> None:
        self._check_fence("delete_lease")
        self._count("delete_lease")
        self.cluster.delete_lease(name)


class ApiWriter(WriterCounts):
    """Write-through to the apiserver; the mirror follows via informers."""

    def __init__(self, kube: KubeClient, cluster: ClusterState, clock: Clock):
        self.kube = kube
        self.cluster = cluster
        self.clock = clock
        self._init_counts()

    # ---- claims ------------------------------------------------------------

    def create_claim(self, claim: NodeClaim) -> None:
        # the write seam's spans name the k8s-object mutations inside the
        # ambient trace (a provisioning pass shows claim-create / pod-bind
        # legs between solve and CreateFleet); contextvars carry the trace
        # across this in-process hop — the httpserver carries it when the
        # same seam is driven over the wire
        self._check_fence("create_claim")
        self._count("create_claim")
        with trace.span("kube.create_nodeclaim", claim=claim.name):
            self.kube.create_nodeclaim(claim)

    def update_claim_status(self, claim: NodeClaim) -> None:
        self._check_fence("update_claim_status")
        self._count("update_claim_status")
        try:
            self.kube.update_nodeclaim(claim)
        except NotFoundError:
            pass  # deleted out from under us; the next reconcile observes it

    def mark_claim_deleting(self, name: str) -> None:
        self._check_fence("mark_claim_deleting")
        self._count("mark_claim_deleting")
        try:
            self.kube.delete_nodeclaim(name, now=self.clock.now())
        except NotFoundError:
            pass
        # the mirror's claim leaves pool_usage() when the MODIFIED event
        # lands; gauges re-render then

    def rollback_claim(self, name: str) -> None:
        self._check_fence("rollback_claim")
        self._count("rollback_claim")
        try:
            self.kube.delete_nodeclaim_now(name)
        except NotFoundError:
            pass

    def finalize_claim(self, claim: NodeClaim) -> None:
        self._check_fence("finalize_claim")
        self._count("finalize_claim")
        self.kube.remove_nodeclaim_finalizer(claim.name)

    # ---- nodes -------------------------------------------------------------

    def register_node(self, node: Node, lease: Optional[Lease] = None) -> None:
        self._check_fence("register_node")
        self._count("register_node")
        self.kube.create_node(node)
        if lease is not None:
            self.kube.create_lease(lease)

    def cordon(self, node: Node, taint) -> bool:
        self._check_fence("cordon")
        try:
            if self.kube.taint_node(node.name, taint):
                self._count("cordon")
                return True
            return False
        except NotFoundError:
            return False

    def drain_node(self, node_name: str) -> Tuple[List[Pod], List[Pod]]:
        """PDB-respecting drain THROUGH the eviction subresource: the
        server enforces budgets (the real Eviction API contract); we
        report (evicted, blocked) from its verdicts. Pod set comes from
        the mirror — the same information a real drainer lists. The
        evictions go as ONE bulk batch (one lock acquisition, one watch
        flush); the server evaluates each pod's PDB allowance in order
        inside the batch, so verdicts match the per-call sequence
        exactly."""
        self._check_fence("drain_node")
        self._count("drain_node")
        pods = [p for p in self.cluster.pods_by_node().get(node_name, [])
                if not p.is_daemonset]
        if not pods:
            return [], []
        results = self.kube.bulk([("evict", p.name) for p in pods])
        evicted: List[Pod] = []
        blocked: List[Pod] = []
        for pod, r in zip(pods, results):
            if isinstance(r, EvictionBlockedError):
                blocked.append(pod)
            elif isinstance(r, NotFoundError):
                continue
            elif isinstance(r, Exception):
                raise r
            else:
                evicted.append(pod)
        return evicted, blocked

    def teardown_node(self, node_name: str) -> None:
        """Final teardown: force-evict stragglers (grace-zero delete
        analog), remove daemonset pods with the node, delete the node —
        all one bulk batch (NotFound slots are raced teardowns)."""
        self._check_fence("teardown_node")
        self._count("teardown_node")
        ops = []
        for pod in self.cluster.pods_by_node().get(node_name, []):
            if pod.is_daemonset:
                ops.append(("delete", "pods", pod.name))
            else:
                ops.append(("evict", pod.name, True))
        ops.append(("delete", "nodes", node_name))
        self.kube.bulk(ops)

    # ---- pods / volumes / leases ------------------------------------------

    def bind_pod(self, pod_name: str, node_name: str) -> bool:
        """Returns False when the bind raced an eviction/delete — the
        watch stream carries whatever the truth is, and callers must not
        count the pod as scheduled (karpenter_pods_scheduled_total would
        overcount)."""
        self._check_fence("bind_pod")
        try:
            with trace.span("kube.bind_pod", pod=pod_name, node=node_name):
                self.kube.bind_pod(pod_name, node_name)
            self._count("bind_pod")
            return True
        except (ConflictError, NotFoundError):
            return False

    def bind_pods(self, pairs: Sequence[Tuple[str, str]]) -> List[bool]:
        """A provisioning pass's binds as ONE coalesced write: the bulk
        verb pays one lock acquisition + one watch flush for the whole
        list — bind_pod was the profiled #1 write-path frame paying
        lock+copy+fan-out per pod. Per-pair verdicts keep the raced-bind
        contract (False = not scheduled)."""
        if not pairs:
            return []
        self._check_fence("bind_pods")
        with trace.span("kube.bind_pods", pods=len(pairs)):
            oks = self.kube.bind_pods(pairs)
        n = sum(oks)
        if n:
            self._count("bind_pod", n)
        self._count("bulk_binds")
        return oks

    def bind_volumes(self, pod_name: str, zone: Optional[str]) -> None:
        """Persist WaitForFirstConsumer zone pins server-side (the CSI
        controller analog); the mirror converges via the pvcs informer."""
        if not zone:
            return
        self._check_fence("bind_volumes")
        self._count("bind_volumes")
        pod = self.cluster.pods.get(pod_name)
        if pod is None:
            return
        for cname in pod.volume_claims:
            pvc = self.cluster.pvcs.get(cname)
            if pvc is not None and pvc.bound_zone is None:
                try:
                    self.kube.patch_pvc(cname, boundZone=zone)
                except NotFoundError:
                    pass

    def delete_lease(self, name: str) -> None:
        self._check_fence("delete_lease")
        self._count("delete_lease")
        self.kube.delete_lease(name)
