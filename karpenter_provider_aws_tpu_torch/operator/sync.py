"""StateSync: informers → ClusterState mirror (+ watch-driven config).

The analog of the core's cluster-state controller consuming informer
events (reference cmd/controller/main.go:50 ``state.NewCluster`` over the
manager's client; metrics.md:150-157 karpenter_cluster_state_synced).
Every kind the controllers read is watched:

- pods/nodes/nodeclaims/pvcs/storageclasses/pdbs/leases apply into the
  ClusterState mirror — the SAME object the deterministic stratum mutates
  directly, so controller read paths are identical across strata.
- nodepools/nodeclasses apply into the operator's config dicts: creating
  a NodePool through the API makes the provisioner see it on the next
  pass — watch-driven configuration, like the reference.

Appliers are deliberately tolerant of ordering (a pod can arrive before
its node; a claim after its node) because watch streams are per-kind.
"""

from __future__ import annotations

from typing import Dict, Optional

from ..apis import serde
from ..apis.objects import NodeClaimPhase, NodePool
from ..kube.apiserver import FakeAPIServer
from ..kube.client import KubeClient
from ..kube.informer import InformerSet
from ..state.cluster import ClusterState
from ..utils.clock import Clock, WALL


class StateSync:
    def __init__(self, server: FakeAPIServer, cluster: ClusterState,
                 node_pools: Dict[str, NodePool],
                 node_classes: Dict[str, object],
                 synced_gauge=None, config_guard=None, recorder=None,
                 pods_state_gauge=None, clock: Clock = None):
        """``config_guard(pool, node_classes) -> Optional[str]`` runs the
        operator's CROSS-object config validations (os-vs-amiFamily,
        storage-config-vs-lattice) on watch-delivered NodePools — per-
        object admission cannot see across objects. A violating pool is
        NOT installed (and an InvalidConfig warning event publishes), the
        watch-stream analog of Operator.__init__ raising for
        programmatically-passed config."""
        self.cluster = cluster
        self.node_pools = node_pools
        self.node_classes = node_classes
        self._synced_gauge = synced_gauge
        self._config_guard = config_guard
        self._recorder = recorder
        self._pods_state_gauge = pods_state_gauge
        self._clock = clock if clock is not None else WALL
        self._pods_state_last = float("-inf")   # clock-driven throttle
        self.informers = InformerSet(server)
        # referents before dependents: config kinds, then volumes/budgets,
        # then claims/nodes, then PODS LAST — apply_pod_spec replays
        # bind_pod whose WaitForFirstConsumer zone pin needs the bound
        # node already in the mirror
        self.informers.add("nodepools", self._on_nodepool)
        self.informers.add("nodeclasses", self._on_nodeclass)
        self.informers.add("storageclasses", self._on_storage_class)
        self.informers.add("pvcs", self._on_pvc)
        self.informers.add("pdbs", self._on_pdb)
        self.informers.add("nodeclaims", self._on_claim)
        self.informers.add("nodes", self._on_node)
        self.informers.add("pods", self._on_pod)
        self.informers.add("leases", self._on_lease)

    # ---- drive -------------------------------------------------------------

    def sync_once(self) -> int:
        """Deterministic pump; returns events applied. Flips the synced
        gauge once every informer has listed (cluster_state_synced)."""
        n = self.informers.sync_once()
        if self._synced_gauge is not None and self.informers.has_synced:
            self._synced_gauge.set(1.0)
        if n and self._pods_state_gauge is not None:
            # pod phases just moved through the watch stream: re-render
            # karpenter_pods_state. Throttled on the INJECTED clock (the
            # pump runs at 20 Hz in the async runtime; the phase scan is
            # O(pods)) — under FakeClock the refresh cadence is
            # deterministic instead of leaking wall time
            now = self._clock.monotonic()
            if now - self._pods_state_last >= 0.5:
                self._pods_state_last = now
                self._pods_state_gauge.replace(
                    {(k,): float(v)
                     for k, v in self.cluster.pod_phase_counts().items()})
        return n

    def start(self) -> "StateSync":
        self.informers.start()
        return self

    def stop(self) -> None:
        self.informers.stop()

    @property
    def has_synced(self) -> bool:
        return self.informers.has_synced

    # ---- appliers ----------------------------------------------------------

    def _on_pod(self, type_, name, obj, old) -> None:
        if type_ == "DELETED":
            self.cluster.delete_pod(name)
            return
        self.cluster.apply_pod_spec(serde.pod_from_dict(obj["spec"]))

    def _on_node(self, type_, name, obj, old) -> None:
        if type_ == "DELETED":
            self.cluster.delete_node(name)
            return
        self.cluster.apply_node(serde.node_from_dict(obj["spec"]))

    def _on_claim(self, type_, name, obj, old) -> None:
        if type_ == "DELETED":
            self.cluster.delete_claim(name)
            return
        self.cluster.apply_claim(KubeClient.claim_from_envelope(obj))

    def _on_pvc(self, type_, name, obj, old) -> None:
        if type_ == "DELETED":
            self.cluster.delete_pvc(name)
            return
        self.cluster.apply_pvc(serde.pvc_from_dict(obj["spec"]))

    def _on_storage_class(self, type_, name, obj, old) -> None:
        if type_ == "DELETED":
            self.cluster.delete_storage_class(name)
            return
        self.cluster.add_storage_class(
            serde.storage_class_from_dict(obj["spec"]))

    def _on_pdb(self, type_, name, obj, old) -> None:
        if type_ == "DELETED":
            self.cluster.delete_pdb(name)
            return
        self.cluster.add_pdb(serde.pdb_from_dict(obj["spec"]))

    def _on_lease(self, type_, name, obj, old) -> None:
        if type_ == "DELETED":
            self.cluster.delete_lease(name)
            return
        if obj["spec"].get("election"):
            # leader-election leases are coordination state, not
            # kube-node-leases: keeping them out of the mirror keeps the
            # ownerless-lease GC off them (the real cluster separates
            # them by namespace)
            return
        self.cluster.add_lease(serde.lease_from_dict(obj["spec"]))

    def _install_pool(self, pool: NodePool) -> None:
        if self._config_guard is not None:
            err = self._config_guard(pool, self.node_classes)
            if err:
                if self._recorder is not None:
                    self._recorder.publish("Warning", "InvalidConfig",
                                           "NodePool", pool.name, err)
                self.node_pools.pop(pool.name, None)
                return
        self.node_pools[pool.name] = pool

    def _on_nodepool(self, type_, name, obj, old) -> None:
        if type_ == "DELETED":
            self.node_pools.pop(name, None)
            return
        # hydrate controller-owned status from the envelope (spec/status
        # split) so a watch re-delivery doesn't zero the typed pool's
        # live usage and trigger a spurious re-patch
        self._install_pool(serde.nodepool_apply_status(
            serde.nodepool_from_dict(obj["spec"]), obj.get("status")))

    def _on_nodeclass(self, type_, name, obj, old) -> None:
        if type_ == "DELETED":
            self.node_classes.pop(name, None)
            return
        self.node_classes[name] = serde.nodeclass_from_dict(obj["spec"])
        # a class change can invalidate (or cure) pools referencing it:
        # re-run the cross-object guard over the server's pool set
        pools_inf = self.informers.informers.get("nodepools")
        if pools_inf is not None:
            for pname, spec in pools_inf.specs().items():
                pool = serde.nodepool_from_dict(spec)
                if pool.node_class_ref == name:
                    self._install_pool(pool)
