"""Kubernetes version provider.

Mirror of reference pkg/providers/version/version.go: control-plane
version discovery (used to parameterize the AMI SSM paths), cached.
"""

from __future__ import annotations

from typing import Optional

from ..cache.ttl import TTLCache
from ..cloud.fake import FakeCloud
from ..utils.clock import Clock

VERSION_TTL = 900.0


class VersionProvider:
    def __init__(self, cloud: FakeCloud, clock: Optional[Clock] = None):
        self.cloud = cloud
        self._cache = TTLCache(VERSION_TTL, clock)

    def get(self) -> str:
        return self._cache.get_or_compute("version",
                                          lambda: self.cloud.network.k8s_version)

    def reset(self) -> None:
        self._cache.flush()
