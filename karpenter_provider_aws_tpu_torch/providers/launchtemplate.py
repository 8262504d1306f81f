"""Launch template provider.

Mirror of reference pkg/providers/launchtemplate/launchtemplate.go:
ensure-or-create launch templates named by content hash (:149-155),
materialized from the AMI family's resolved launch parameters + security
groups + instance profile (:241-318), a cache whose eviction deletes the
stale cloud template (delete-on-evict GC, :372-389), and startup cache
hydration (:355-370).
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Optional

from ..apis.objects import NodeClass
from ..cache.ttl import TTLCache
from ..cloud.fake import FakeCloud
from ..cloud.network import LaunchTemplate
from ..errors import AlreadyExistsError, NotFoundError
from ..utils.clock import Clock
from .amifamily import AMIProvider, LaunchParameters
from .instanceprofile import InstanceProfileProvider
from .securitygroup import SecurityGroupProvider

LAUNCH_TEMPLATE_TTL = 300.0
LT_PREFIX = "karpenter.sim"


class LaunchTemplateProvider:
    def __init__(self, cloud: FakeCloud,
                 security_groups: SecurityGroupProvider,
                 instance_profiles: InstanceProfileProvider,
                 amis: AMIProvider,
                 clock: Optional[Clock] = None,
                 cluster_name: str = "sim"):
        self.cloud = cloud
        self.security_groups = security_groups
        self.instance_profiles = instance_profiles
        self.amis = amis
        self.cluster_name = cluster_name
        # evicting a template from the cache deletes the cloud object — the
        # reference's stale-LT GC (launchtemplate.go:372-389)
        self._cache = TTLCache(LAUNCH_TEMPLATE_TTL, clock, on_evict=self._evict)
        self._hydrated = False

    def _evict(self, name: str, _lt) -> None:
        try:
            self.cloud.network.delete_launch_template(name)
        except NotFoundError:
            pass

    def _lt_name(self, content_hash: str) -> str:
        return f"{LT_PREFIX}/{content_hash}"

    def hydrate(self) -> int:
        """Prime the cache from cloud state on startup (after leader
        election in the reference, :100-108, :355-370)."""
        if self._hydrated:
            return 0
        n = 0
        for lt in self.cloud.network.describe_launch_templates(
                tags={f"karpenter.sim/cluster": self.cluster_name}):
            self._cache.set(lt.name, lt)
            n += 1
        self._hydrated = True
        return n

    def ensure_all(self, node_class: NodeClass, k8s_version: str,
                   cluster_dns: Optional[str] = None) -> List[LaunchTemplate]:
        """One launch template per resolved (AMI, arch) launch parameter set
        (EnsureAll, :112-136). ``cluster_dns`` parameterizes the userdata
        (it feeds the content hash, so a pool-level kubelet ClusterDNS
        override gets its own template)."""
        self.hydrate()
        sgs = tuple(g.id for g in self.security_groups.list(node_class))
        profile = self.instance_profiles.create(node_class)
        out: List[LaunchTemplate] = []
        for params in self.amis.resolve_launch_parameters(
                node_class, k8s_version, cluster_dns=cluster_dns):
            out.append(self._ensure_one(node_class, params, sgs, profile))
        return out

    def _ensure_one(self, node_class: NodeClass, params: LaunchParameters,
                    sg_ids, profile: str) -> LaunchTemplate:
        content = "|".join([
            params.ami.id, params.user_data, ",".join(sg_ids), profile,
            repr(sorted(node_class.tags.items())),
            repr(vars(node_class.metadata_options)),
            repr(node_class.block_device_mappings),
        ])
        h = hashlib.sha256(content.encode()).hexdigest()[:16]
        name = self._lt_name(h)
        cached = self._cache.get(name)
        if cached is not None:
            # refresh expiry on use: an actively-referenced template must
            # never be evicted (and thereby GC'd from the cloud) mid-use
            self._cache.set(name, cached)
            return cached
        existing = self.cloud.network.describe_launch_templates(names=[name])
        if existing:
            self._cache.set(name, existing[0])
            return existing[0]
        lt = LaunchTemplate(
            id="", name=name, image_id=params.ami.id, user_data=params.user_data,
            security_group_ids=tuple(sg_ids), instance_profile=profile,
            tags={"karpenter.sim/cluster": self.cluster_name,
                  "karpenter.sim/nodeclass": node_class.name},
            metadata_options=dict(vars(node_class.metadata_options)),
            block_device_mappings=tuple(map(repr, node_class.block_device_mappings)))
        try:
            lt = self.cloud.network.create_launch_template(lt)
        except AlreadyExistsError:
            lt = self.cloud.network.describe_launch_templates(names=[name])[0]
        self._cache.set(name, lt)
        return lt

    def delete_all(self, node_class: NodeClass) -> int:
        """Delete the NodeClass's templates (nodeclass finalizer flow)."""
        n = 0
        for lt in self.cloud.network.describe_launch_templates(
                tags={"karpenter.sim/nodeclass": node_class.name}):
            try:
                self.cloud.network.delete_launch_template(lt.name)
                n += 1
            except NotFoundError:
                pass
            self._cache.delete(lt.name)
        return n

    def cleanup(self) -> int:
        """Periodic cache sweep; evictions GC stale cloud templates."""
        return self._cache.cleanup()

    def reset(self) -> None:
        self._cache.flush()
        self._hydrated = False
