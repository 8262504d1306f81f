"""Termination controller: finalizer-style drain then instance delete.

Mirror of the core termination flow (reference designs/termination.md;
website concepts/disruption.md:29-36): a NodeClaim with a deletion
timestamp gets its node tainted (cordon), pods evicted back to pending,
then CloudProvider.Delete terminates the instance, and finally the claim
and node objects are removed (finalizer cleared).
"""

from __future__ import annotations

from typing import Optional

from ..apis.objects import NodeClaim, NodeClaimPhase, Taint, TaintEffect
from ..apis import wellknown as wk
from ..cloudprovider.cloudprovider import CloudProvider
from ..errors import NotFoundError
from ..events import Recorder
from ..metrics import Registry, wire_core_metrics
from ..state.cluster import ClusterState
from ..utils.clock import Clock

DISRUPTION_TAINT = Taint(key=f"{wk.KARPENTER_PREFIX}/disruption", value="disrupting",
                         effect=TaintEffect.NO_SCHEDULE)


class TerminationController:
    def __init__(self, cluster: ClusterState, cloud_provider: CloudProvider,
                 recorder: Optional[Recorder] = None, clock: Optional[Clock] = None,
                 metrics: Optional[Registry] = None,
                 termination_grace_period: Optional[float] = None,
                 writer=None):
        self.cluster = cluster
        self.cloud_provider = cloud_provider
        self.clock = clock or Clock()
        from ..kube.writer import DirectWriter
        self.writer = writer or DirectWriter(cluster, self.clock)
        self.recorder = recorder or Recorder(self.clock)
        # None = a PDB-blocked drain waits forever (the pinned reference
        # release); a float force-drains claims terminating longer than
        # this, so a zero-allowance budget cannot bill an instance forever
        self.termination_grace_period = termination_grace_period
        # claims whose DrainBlocked event already published this episode
        self._drain_blocked_logged: set = set()
        m = wire_core_metrics(metrics or Registry())
        self._m_terminated = m["nodeclaims_terminated"]

    def delete_claim(self, claim_name: str) -> None:
        """Mark for deletion (the k8s delete that starts the finalizer flow)."""
        self.writer.mark_claim_deleting(claim_name)

    def reconcile(self) -> None:
        for claim in list(self.cluster.claims.values()):
            if not claim.deletion_timestamp:
                continue
            node = self.cluster.node_for_claim(claim.name)
            if node is not None:
                # cordon, then PDB-respecting drain: the node is deleted
                # only once fully drained (reference disruption.md:33 —
                # evict via the Eviction API to respect PDBs, wait for the
                # node to be fully drained before terminating)
                if self.writer.cordon(node, DISRUPTION_TAINT):
                    self.recorder.publish("Normal", "Cordoned", "Node", node.name, "")
                evicted, blocked = self.writer.drain_node(node.name)
                if evicted:
                    self.recorder.publish("Normal", "Drained", "Node", node.name,
                                          f"evicted {len(evicted)} pod(s)")
                grace_expired = (
                    self.termination_grace_period is not None
                    and self.clock.now() - claim.deletion_timestamp
                    >= self.termination_grace_period)
                if blocked and grace_expired:
                    # force-drain backstop: the budget lost its veto; the
                    # blocked pods evict in the final teardown below
                    self.recorder.publish(
                        "Warning", "ForceDrained", "Node", node.name,
                        f"termination grace period expired; evicting "
                        f"{len(blocked)} budget-blocked pod(s)")
                    blocked = []
                if blocked:
                    # retry next pass: rescheduled pods going healthy
                    # elsewhere restore the budgets' allowance. One event
                    # per blockage episode — this runs every second in
                    # the async runtime and must not flood the recorder
                    if claim.name not in self._drain_blocked_logged:
                        self._drain_blocked_logged.add(claim.name)
                        pdb = self.cluster.pdb_blockers(blocked)
                        self.recorder.publish(
                            "Warning", "DrainBlocked", "Node", node.name,
                            f"{len(blocked)} pod(s) await disruption budget "
                            f"({', '.join(sorted(set(pdb.values())) or ['-'])})")
                    continue
                self._drain_blocked_logged.discard(claim.name)
                # fully drained (or force-drained): final teardown evicts
                # any stragglers and deletes daemonset pods with the node
                self.writer.teardown_node(node.name)
            if claim.provider_id is not None:
                try:
                    self.cloud_provider.delete(claim)
                except NotFoundError:
                    pass
            claim.phase = NodeClaimPhase.TERMINATED
            self._m_terminated.inc(nodepool=claim.node_pool)
            self._drain_blocked_logged.discard(claim.name)
            # finalizer cleared -> the claim object is removed
            self.writer.finalize_claim(claim)
            self.recorder.publish("Normal", "Terminated", "NodeClaim", claim.name, "")
