"""Leaked-capacity garbage collection.

Mirror of the reference's nodeclaim GC controller (reference
pkg/controllers/nodeclaim/garbagecollection/controller.go:55-89): cloud
instances older than 30 s with no matching NodeClaim are terminated
(launch succeeded but the claim write was lost), and claims whose backing
instance disappeared are removed so their pods reschedule. Also owns the
NodePool deletion cascade: the reference gets it from kube garbage
collection (claims carry an ownerReference to their NodePool, so
deleting the pool foreground-deletes the claims, whose termination
finalizer then drains them gracefully — reference nodepools.md
"deleting a NodePool deletes its nodes"); with no kube GC here, this
controller marks a gone pool's claims deleting, which starts the same
PDB-paced finalizer drain.
"""

from __future__ import annotations

from typing import Callable, Optional

from ..apis.objects import NodeClaimPhase
from ..cloud.fake import parse_instance_id
from ..cloudprovider.cloudprovider import CloudProvider
from ..errors import NotFoundError
from ..events import Recorder
from ..state.cluster import ClusterState
from ..utils.clock import Clock

LEAK_GRACE_SECONDS = 30.0  # garbagecollection/controller.go:64


class GarbageCollectionController:
    def __init__(self, cluster: ClusterState, cloud_provider: CloudProvider,
                 recorder: Optional[Recorder] = None, clock: Optional[Clock] = None,
                 writer=None,
                 pool_exists: Optional[Callable[[str], bool]] = None):
        from ..utils.fanout import LazyPool
        self.cluster = cluster
        self.cloud_provider = cloud_provider
        self.clock = clock or Clock()
        from ..kube.writer import DirectWriter
        self.writer = writer or DirectWriter(cluster, self.clock)
        self.recorder = recorder or Recorder(self.clock)
        # ``pool_exists(name) -> bool`` answers whether the NodePool still
        # exists AT THE SOURCE OF TRUTH (the operator's pool dict, or the
        # nodepools informer store in API mode — NOT the config-guarded
        # active dict, where an invalid-config pool is absent but its
        # nodes must survive). None disables the cascade.
        self.pool_exists = pool_exists
        # claims already cascaded: in API mode the mirror's
        # deletion_timestamp lags the server write by one informer pump,
        # and re-entering the branch each tick would spam duplicate
        # NodePoolDeleted events (the server-side delete itself is a
        # no-op). Pruned when the claim leaves the mirror.
        self._cascaded: set = set()
        self._pool = LazyPool(self.EXISTENCE_WORKERS, "gc-exists")

    # reference garbagecollection/controller.go:78 checks 100-way parallel
    EXISTENCE_WORKERS = 100

    def reconcile(self) -> None:
        now = self.clock.now()
        claims = [c for c in list(self.cluster.claims.values())
                  if c.provider_id is not None]
        claimed_ids = {parse_instance_id(c.provider_id) for c in claims}

        # existence checks fan out (the cloud round trip is the slow part);
        # state mutation happens serially afterwards under one thread
        def exists(claim) -> bool:
            try:
                self.cloud_provider.get(claim.provider_id)
                return True
            except NotFoundError:
                return False

        alive = self._pool.run(claims, exists)
        for claim, ok in zip(claims, alive):
            if ok:
                continue
            # claim whose instance vanished out from under it -> delete the
            # claim (+node) so its pods reschedule
            iid = parse_instance_id(claim.provider_id)
            self.recorder.publish("Warning", "InstanceDisappeared", "NodeClaim",
                                  claim.name, f"instance {iid} is gone")
            node = self.cluster.node_for_claim(claim.name)
            if node is not None:
                # teardown deletes daemonset pods with the node — no
                # phantom overhead in future node sizing
                self.writer.teardown_node(node.name)
            # the backing instance is GONE: hard delete, no finalizer round
            self.writer.rollback_claim(claim.name)
        # leaked instances: running but unclaimed past the grace window
        for inst in self.cloud_provider.list_instances():
            if inst.id in claimed_ids or inst.state == "terminated":
                continue
            if now - inst.launch_time < LEAK_GRACE_SECONDS:
                continue
            self.recorder.publish("Warning", "LeakedInstance", "Instance", inst.id,
                                  "terminating instance with no nodeclaim")
            try:
                self.cloud_provider.cloud.terminate_instances([inst.id])
            except NotFoundError:
                pass
        # orphaned node leases: no owner reference, or the owner node is
        # gone (the kubelet that would heartbeat it no longer exists) —
        # reference integration/lease_garbagecollection_test.go
        for name in self.cluster.orphaned_leases():
            self.recorder.publish("Normal", "LeaseGarbageCollected", "Lease",
                                  name, "deleting orphaned node lease")
            self.writer.delete_lease(name)
        # NodePool deletion cascade (see module docstring): a gone pool's
        # claims start the graceful finalizer drain — never a hard
        # rollback; PDBs and grace periods pace the eviction exactly as
        # in voluntary disruption
        if self.pool_exists is not None:
            live = set()
            for claim in list(self.cluster.claims.values()):
                live.add(claim.name)
                if (claim.deletion_timestamp or not claim.node_pool
                        or claim.name in self._cascaded):
                    continue
                if not self.pool_exists(claim.node_pool):
                    self.recorder.publish(
                        "Normal", "NodePoolDeleted", "NodeClaim", claim.name,
                        f"nodepool {claim.node_pool} is gone; draining")
                    self.writer.mark_claim_deleting(claim.name)
                    self._cascaded.add(claim.name)
            self._cascaded &= live
