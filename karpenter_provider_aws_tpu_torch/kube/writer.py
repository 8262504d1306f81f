"""The controllers' write seam: every Kubernetes-object mutation a
controller makes goes through this interface.

The port of the JAX package's ``kube/writer.py``, its simulation-stratum
half: ``FencedWriteError``, ``WriterCounts`` and ``DirectWriter``, which
applies writes straight into the ClusterState mirror — the deterministic
simulation stratum (FakeClock unit tests), where read-your-write is
immediate.

Not ported yet: ``ApiWriter``, which writes to the fake apiserver through
the typed client and lets the mirror follow through informers. It needs
the kube API stratum (``kube/apiserver.py``, ``kube/client.py``), which
waits for the Operator; this module imports neither.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from ..apis.objects import Lease, Node, NodeClaim, NodeClaimPhase, Pod
from ..state.cluster import ClusterState
from ..utils.clock import Clock


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
    """Per-verb write-throughput counters of a writer (the introspection
    registry's ``writer`` provider): per-verb rates for profiling the
    write path."""

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
