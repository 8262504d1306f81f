"""NodeClaim lifecycle: launch → register → initialize, with liveness GC.

Mirror of the core nodeclaim lifecycle state machine (reference: NodeClaim
CRD status conditions, metrics karpenter_nodeclaims_{launched,registered,
initialized} per website reference/metrics.md:76-97). The simulated kubelet
registers a Node a configurable delay after launch (stratum-2 "no real
cluster" testing, like the reference's envtest + fake EC2); claims that
never register within the liveness TTL are deleted and relaunched by the
next provisioning pass (core's 15-minute registration liveness).
"""

from __future__ import annotations

import itertools
from typing import List, Optional

from .. import trace
from ..apis import wellknown as wk
from ..apis.objects import Lease, Node, NodeClaim, NodeClaimPhase
from ..cloudprovider.cloudprovider import CloudProvider
from ..errors import NotFoundError
from ..events import Recorder
from ..metrics import Registry, wire_core_metrics
from ..state.cluster import ClusterState
from ..utils.clock import Clock

REGISTRATION_TTL = 15 * 60.0   # core liveness: claims must register in 15 min


class LifecycleController:
    def __init__(self, cluster: ClusterState, cloud_provider: CloudProvider,
                 recorder: Optional[Recorder] = None, clock: Optional[Clock] = None,
                 registration_delay: float = 5.0,
                 metrics: Optional[Registry] = None,
                 writer=None):
        self.cluster = cluster
        self.cloud_provider = cloud_provider
        self.clock = clock or Clock()
        from ..kube.writer import DirectWriter
        self.writer = writer or DirectWriter(cluster, self.clock)
        self.recorder = recorder or Recorder(self.clock)
        self.registration_delay = registration_delay
        m = wire_core_metrics(metrics or Registry())
        self._m_registered = m["nodeclaims_registered"]
        self._m_initialized = m["nodeclaims_initialized"]

    def reconcile(self) -> None:
        now = self.clock.now()
        for claim in list(self.cluster.claims.values()):
            if claim.deletion_timestamp:
                continue
            if claim.phase == NodeClaimPhase.LAUNCHED:
                if claim.launched_at is not None and now - claim.launched_at >= self.registration_delay:
                    node = self._register(claim)
                    # sim nodes are born Ready; pass the node we just
                    # registered — in API mode the mirror only learns of
                    # it at the next informer pump
                    self._initialize(claim, node=node)
                elif now - claim.created_at > REGISTRATION_TTL:
                    self._liveness_delete(claim, "registration deadline exceeded")
            elif claim.phase == NodeClaimPhase.PENDING:
                if now - claim.created_at > REGISTRATION_TTL:
                    self._liveness_delete(claim, "launch deadline exceeded")
            elif claim.phase == NodeClaimPhase.REGISTERED:
                self._initialize(claim)

    def _register(self, claim: NodeClaim) -> "Node":
        """Simulated kubelet joins the node and binds nominated pods.
        The registration span re-joins the provisioning pass's trace via
        the claim's traceparent annotation — the LAST hop of the causal
        chain (REST write → batch → solve → CreateFleet → registration),
        crossing the launch delay the claim spent in the cloud."""
        tp = claim.annotations.get(wk.ANNOTATION_TRACEPARENT)
        if tp is None:
            # no originating trace: registering under a fresh root would
            # only churn the recorder ring with single-span noise
            return self._register_traced(claim)
        with trace.span("nodeclaim.register", parent=tp,
                        nodeclaim=claim.name, nodepool=claim.node_pool):
            return self._register_traced(claim)

    def _register_traced(self, claim: NodeClaim) -> "Node":
        node = Node(
            name=claim.name, provider_id=claim.provider_id or "",
            internal_ip=claim.internal_ip,
            labels=dict(claim.labels), taints=list(claim.taints),
            capacity=dict(claim.capacity), allocatable=dict(claim.allocatable),
            ready=True, created_at=self.clock.now(),
            node_pool=claim.node_pool, node_claim=claim.name)
        # the (fake) kubelet joins the node and creates its coordination
        # lease — through the writer seam, like every k8s-object write
        self.writer.register_node(node, Lease(
            name=node.name, owner_node=node.name,
            created_at=self.clock.now()))
        # all of the claim's nominated pods bind as ONE coalesced write
        # (the apiserver bulk verb in API mode): registration of a
        # full node used to pay lock + watch fan-out per pod
        self.writer.bind_pods([(pod.name, node.name)
                               for pod in self.cluster.nominated_pods(claim.name)])
        claim.phase = NodeClaimPhase.REGISTERED
        claim.registered_at = self.clock.now()
        self.writer.update_claim_status(claim)
        self._m_registered.inc(nodepool=claim.node_pool)
        self.recorder.publish("Normal", "Registered", "NodeClaim", claim.name,
                              f"node {node.name} joined")
        return node

    def _initialize(self, claim: NodeClaim, node=None) -> None:
        """Registered → Initialized once the node is Ready and startup
        taints cleared (the sim node is born ready)."""
        if node is None:
            node = self.cluster.node_for_claim(claim.name)
        if node is None or not node.ready:
            return
        claim.phase = NodeClaimPhase.INITIALIZED
        claim.initialized_at = self.clock.now()
        self.writer.update_claim_status(claim)
        self._m_initialized.inc(nodepool=claim.node_pool)
        self.recorder.publish("Normal", "Initialized", "NodeClaim", claim.name, "")

    def _liveness_delete(self, claim: NodeClaim, reason: str) -> None:
        self.recorder.publish("Warning", "LivenessFailure", "NodeClaim", claim.name, reason)
        if claim.provider_id is not None:
            try:
                self.cloud_provider.delete(claim)
            except NotFoundError:
                pass
        # the instance (if any) is gone and no node ever registered: a
        # hard delete, no drain/finalizer round needed
        self.writer.rollback_claim(claim.name)
