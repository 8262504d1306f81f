"""Subnet provider.

Mirror of reference pkg/providers/subnet/subnet.go: selector-term discovery
(:58-94), zonal subnet choice by most free IPs with in-flight IP
accounting (:109-145, :148-204). The in-flight bookkeeping matters: many
launches in one batch must not all pick the same almost-full subnet.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

from ..apis.objects import NodeClass, NodeClassSelectorTerm
from ..cache.ttl import TTLCache
from ..cloud.fake import FakeCloud
from ..cloud.network import Subnet
from ..utils.clock import Clock

SUBNET_TTL = 60.0  # default 1-min cache (reference cache.go:26)


class SubnetProvider:
    def __init__(self, cloud: FakeCloud, clock: Optional[Clock] = None,
                 cluster_name: str = "sim"):
        self.cloud = cloud
        self.cluster_name = cluster_name
        self._cache = TTLCache(SUBNET_TTL, clock)
        self._clock = clock or Clock()
        # in-flight IP bookings decay after the subnet-cache window: by then
        # the describe refresh reflects the launched instances' real usage
        # (reference re-baselines the same way, subnet.go:148-204)
        self._inflight: Dict[str, List[Tuple[float, int]]] = {}
        self._lock = threading.Lock()

    def list(self, node_class: NodeClass) -> List[Subnet]:
        """Resolve the NodeClass's subnet selector terms (OR across terms)."""
        terms = node_class.subnet_selector_terms or [
            NodeClassSelectorTerm(tags=((f"kubernetes.io/cluster/{self.cluster_name}", "*"),))]
        key = repr(sorted((t.id, t.name, tuple(sorted(t.tags))) for t in terms))

        def fetch():
            found: Dict[str, Subnet] = {}
            for t in terms:
                if t.id:
                    for s in self.cloud.network.describe_subnets(ids=[t.id]):
                        found[s.id] = s
                else:
                    for s in self.cloud.network.describe_subnets(tags=dict(t.tags)):
                        found[s.id] = s
            return sorted(found.values(), key=lambda s: s.id)

        return self._cache.get_or_compute(key, fetch)

    def _inflight_for(self, subnet_id: str) -> int:
        now = self._clock.now()
        entries = self._inflight.get(subnet_id)
        if not entries:
            return 0
        live = [(exp, n) for exp, n in entries if exp > now]
        self._inflight[subnet_id] = live
        return sum(n for _, n in live)

    def zonal_subnets_for_launch(self, node_class: NodeClass) -> Dict[str, Subnet]:
        """zone -> chosen subnet (max free IPs minus in-flight, subnet.go:109-145)."""
        with self._lock:
            best: Dict[str, Subnet] = {}
            for s in self.list(node_class):
                free = s.available_ips - self._inflight_for(s.id)
                cur = best.get(s.zone)
                cur_free = (cur.available_ips - self._inflight_for(cur.id)) if cur else -1
                if free > cur_free:
                    best[s.zone] = s
            return best

    def update_inflight_ips(self, subnet_id: str, ips: int = 1) -> None:
        """Book IPs consumed by a just-issued launch (subnet.go:148-204);
        bookings expire with the describe-cache window, when the refreshed
        subnet data reflects them for real."""
        with self._lock:
            self._inflight.setdefault(subnet_id, []).append(
                (self._clock.now() + SUBNET_TTL, ips))

    def reset(self) -> None:
        with self._lock:
            self._inflight.clear()
        self._cache.flush()
