"""Security group provider.

Mirror of reference pkg/providers/securitygroup/securitygroup.go:54-94:
tag/id/name selector-term discovery with a hash-keyed TTL cache.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ..apis.objects import NodeClass, NodeClassSelectorTerm
from ..cache.ttl import TTLCache
from ..cloud.fake import FakeCloud
from ..cloud.network import SecurityGroup
from ..utils.clock import Clock

SECURITY_GROUP_TTL = 60.0


class SecurityGroupProvider:
    def __init__(self, cloud: FakeCloud, clock: Optional[Clock] = None,
                 cluster_name: str = "sim"):
        self.cloud = cloud
        self.cluster_name = cluster_name
        self._cache = TTLCache(SECURITY_GROUP_TTL, clock)

    def list(self, node_class: NodeClass) -> List[SecurityGroup]:
        terms = node_class.security_group_selector_terms or [
            NodeClassSelectorTerm(tags=((f"kubernetes.io/cluster/{self.cluster_name}", "*"),))]
        key = repr(sorted((t.id, t.name, tuple(sorted(t.tags))) for t in terms))

        def fetch():
            found: Dict[str, SecurityGroup] = {}
            for t in terms:
                if t.id:
                    for g in self.cloud.network.describe_security_groups(ids=[t.id]):
                        found[g.id] = g
                elif t.name:
                    for g in self.cloud.network.describe_security_groups(names=[t.name]):
                        found[g.id] = g
                else:
                    for g in self.cloud.network.describe_security_groups(tags=dict(t.tags)):
                        found[g.id] = g
            return sorted(found.values(), key=lambda g: g.id)

        return self._cache.get_or_compute(key, fetch)

    def reset(self) -> None:
        self._cache.flush()
