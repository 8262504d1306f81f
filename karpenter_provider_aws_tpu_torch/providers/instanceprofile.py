"""Instance profile provider.

Mirror of reference pkg/providers/instanceprofile/instanceprofile.go:
create/reconcile/delete an IAM instance profile per NodeClass role
(:50-128), with the deterministic name = hash(region + nodeclass)
(:130-134) and a long-TTL cache (15 min, reference cache.go:33).
"""

from __future__ import annotations

import hashlib
from typing import Optional

from ..apis.objects import NodeClass
from ..cache.ttl import TTLCache
from ..cloud.fake import FakeCloud
from ..errors import AlreadyExistsError, NotFoundError
from ..utils.clock import Clock

INSTANCE_PROFILE_TTL = 900.0
REGION = "us-west-2"


def profile_name(node_class_name: str, region: str = REGION) -> str:
    digest = hashlib.sha256(f"{region}/{node_class_name}".encode()).hexdigest()[:20]
    return f"karpenter_{digest}"


class InstanceProfileProvider:
    def __init__(self, cloud: FakeCloud, clock: Optional[Clock] = None):
        self.cloud = cloud
        self._cache = TTLCache(INSTANCE_PROFILE_TTL, clock)

    def create(self, node_class: NodeClass) -> str:
        """Ensure the profile exists with the NodeClass's role; returns its
        name. Explicit spec.instance_profile wins over role-derived
        (ec2nodeclass spec precedence)."""
        if node_class.instance_profile:
            return node_class.instance_profile
        if not node_class.role:
            raise ValueError(f"nodeclass {node_class.name}: role or instance_profile required")
        name = profile_name(node_class.name)
        if name in self._cache:
            return name

        try:
            existing = self.cloud.network.get_instance_profile(name)
            if existing.role != node_class.role:
                # role changed: recreate (reference reconciles the role)
                self.cloud.network.delete_instance_profile(name)
                raise NotFoundError(name)
        except NotFoundError:
            try:
                self.cloud.network.create_instance_profile(name, node_class.role)
            except AlreadyExistsError:
                pass
        self._cache.set(name, True)
        return name

    def delete(self, node_class: NodeClass) -> None:
        if node_class.instance_profile:
            return  # user-managed profile: never delete
        name = profile_name(node_class.name)
        try:
            self.cloud.network.delete_instance_profile(name)
        except NotFoundError:
            pass
        self._cache.delete(name)

    def reset(self) -> None:
        self._cache.flush()
