"""NodeClass controller: status hydration + finalizer.

Mirror of reference pkg/controllers/nodeclass/controller.go: reconcile
resolves the NodeClass's subnets / security groups / AMIs / instance
profile into status (:150-233), stamps the spec hash annotation for drift
versioning (:84-92, :239-272), re-resolves every 5 minutes (:117), and the
finalizer blocks deletion until no NodeClaims reference the class, then
deletes the instance profile and launch templates (:120-148).
"""

from __future__ import annotations

from typing import Dict, Optional

from ..apis.objects import NodeClass
from ..apis import wellknown as wk
from ..cloudprovider.cloudprovider import nodeclass_hash
from ..events import Recorder
from ..providers.amifamily import AMIProvider
from ..providers.instanceprofile import InstanceProfileProvider
from ..providers.launchtemplate import LaunchTemplateProvider
from ..providers.securitygroup import SecurityGroupProvider
from ..providers.subnet import SubnetProvider
from ..providers.version import VersionProvider
from ..state.cluster import ClusterState
from ..utils.clock import Clock

RECONCILE_INTERVAL = 300.0  # requeue every 5 min (controller.go:117)


class NodeClassController:
    def __init__(self, node_classes: Dict[str, NodeClass],
                 cluster: ClusterState,
                 subnets: SubnetProvider,
                 security_groups: SecurityGroupProvider,
                 amis: AMIProvider,
                 instance_profiles: InstanceProfileProvider,
                 launch_templates: LaunchTemplateProvider,
                 version: VersionProvider,
                 recorder: Optional[Recorder] = None,
                 clock: Optional[Clock] = None):
        self.node_classes = node_classes
        self.cluster = cluster
        self.subnets = subnets
        self.security_groups = security_groups
        self.amis = amis
        self.instance_profiles = instance_profiles
        self.launch_templates = launch_templates
        self.version = version
        self.clock = clock or Clock()
        self.recorder = recorder or Recorder(self.clock)
        self._last: Dict[str, float] = {}
        self._deleting: Dict[str, bool] = {}

    def reconcile(self) -> None:
        now = self.clock.now()
        for nc in list(self.node_classes.values()):
            if self._deleting.get(nc.name):
                self._finalize(nc)
                continue
            if now - self._last.get(nc.name, -1e18) < RECONCILE_INTERVAL:
                continue
            self._hydrate(nc)
            self._last[nc.name] = now

    def _hydrate(self, nc: NodeClass) -> None:
        """Resolve spec → status (controller.go:150-233)."""
        ready = True
        nc.status_subnets = [{"id": s.id, "zone": s.zone,
                              "zoneType": s.zone_type}
                             for s in self.subnets.list(nc)]
        nc.status_security_groups = [{"id": g.id, "name": g.name}
                                     for g in self.security_groups.list(nc)]
        v = self.version.get()
        try:
            nc.status_amis = [{"id": a.id, "name": a.name, "arch": a.arch}
                              for a in self.amis.list(nc, v)]
        except ValueError as e:
            # e.g. unknown AMI family: degrade the class to NotReady (the
            # reference sets status conditions; it never crashes the manager)
            nc.status_amis = []
            self.recorder.publish("Warning", "NodeClassResolveFailed", "NodeClass",
                                  nc.name, str(e))
        try:
            nc.status_instance_profile = self.instance_profiles.create(nc)
        except ValueError:
            nc.status_instance_profile = None
        if not nc.status_subnets or not nc.status_security_groups or not nc.status_amis:
            ready = False
        # spec-hash annotation for drift versioning (controller.go:84-92)
        nc.annotations[wk.ANNOTATION_NODECLASS_HASH] = nodeclass_hash(nc)
        nc.status_conditions["Ready"] = ready
        nc.status_conditions["SubnetsReady"] = bool(nc.status_subnets)
        nc.status_conditions["SecurityGroupsReady"] = bool(nc.status_security_groups)
        nc.status_conditions["AMIsReady"] = bool(nc.status_amis)
        if not ready:
            self.recorder.publish("Warning", "NodeClassNotReady", "NodeClass", nc.name,
                                  f"unresolved: subnets={len(nc.status_subnets)} "
                                  f"sgs={len(nc.status_security_groups)} amis={len(nc.status_amis)}")

    def delete(self, name: str) -> None:
        """Begin NodeClass deletion (sets the finalizer-pending flag)."""
        if name in self.node_classes:
            self._deleting[name] = True

    def _finalize(self, nc: NodeClass) -> None:
        """Block until no claims reference the class, then clean the cloud
        side (controller.go:120-148)."""
        in_use = any(c.node_class_ref == nc.name for c in self.cluster.snapshot_claims())
        if in_use:
            self.recorder.publish("Warning", "NodeClassDeleteBlocked", "NodeClass",
                                  nc.name, "nodeclaims still reference this class")
            return
        self.instance_profiles.delete(nc)
        self.launch_templates.delete_all(nc)
        self.node_classes.pop(nc.name, None)
        self._deleting.pop(nc.name, None)
        self.recorder.publish("Normal", "NodeClassDeleted", "NodeClass", nc.name, "")
