"""In-memory behavioral cloud backend.

Mirror of the reference's fake EC2 (reference pkg/fake/ec2api.go): a fleet
launch honors configured insufficient-capacity pools and picks the
lowest-priced available override (the CreateFleet lowest-price allocation
strategy); instances are describable/terminable; every API records its
calls and supports one-shot error injection (`next_error`, the
reference's AtomicError at ec2api.go:58-67). This is the stratum-2 test
backend AND the default backend of the simulation environment — swap in a
real cloud by implementing the same surface.
"""

from __future__ import annotations

import collections
import itertools
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from ..errors import NotFoundError, Offering, UnfulfillableCapacityError
from ..utils.clock import Clock


@dataclass
class LaunchOverride:
    """One (type, zone, capacity_type) candidate with its bid price."""

    instance_type: str
    zone: str
    capacity_type: str
    price: float

    @property
    def offering(self) -> Offering:
        return (self.capacity_type, self.instance_type, self.zone)


@dataclass
class CloudInstance:
    id: str
    instance_type: str
    zone: str
    capacity_type: str
    state: str = "running"            # pending|running|shutting-down|terminated
    launch_time: float = 0.0
    price: float = 0.0
    tags: Dict[str, str] = field(default_factory=dict)
    # launch materialization, consulted by live drift detection
    # (reference drift.go:44-135 compares these against the NodeClass)
    image_id: Optional[str] = None
    subnet_id: Optional[str] = None
    security_group_ids: Tuple[str, ...] = ()
    private_ip: Optional[str] = None  # InternalIP; v6 on ipv6 clusters

    @property
    def provider_id(self) -> str:
        return f"fake:///{self.zone}/{self.id}"


@dataclass
class FleetResult:
    """CreateFleet outcome: the launched instance plus the exhausted
    offerings skipped by the lowest-price walk (the analog of
    CreateFleetOutput.Instances + .Errors)."""

    instance: CloudInstance
    ice: List[Offering] = field(default_factory=list)


def parse_instance_id(provider_id: str) -> str:
    """Mirror of utils.ParseInstanceID over 'fake:///zone/i-…' provider IDs
    (reference pkg/utils/utils.go)."""
    parts = provider_id.rsplit("/", 1)
    if len(parts) != 2 or not parts[1]:
        raise ValueError(f"malformed provider id {provider_id!r}")
    return parts[1]


class FakeCloud:
    """Thread-safe in-memory cloud. Capacity pools: offering -> remaining
    instance count (absent = unlimited; 0 = ICE), mirroring
    InsufficientCapacityPools (ec2api.go:40-44, 112-190)."""

    def __init__(self, clock: Optional[Clock] = None,
                 cluster_name: str = "sim", k8s_version: str = "1.29",
                 ip_family: str = "ipv4"):
        from .network import FakeNetwork
        self.clock = clock or Clock()
        self._lock = threading.RLock()
        self._ids = itertools.count(1)
        self.instances: Dict[str, CloudInstance] = {}
        self.capacity_pools: Dict[Offering, int] = {}
        self.next_error: Optional[BaseException] = None
        # bounded: a long-running daemon polls list/describe every pass
        self.calls: "collections.deque[Tuple[str, object]]" = \
            collections.deque(maxlen=10000)
        # the session's assumed role, recorded by assume_role (the STS
        # layering seam, reference operator.go:93-107); None = base
        # credentials
        self.assumed_role_arn: Optional[str] = None
        # the VPC/IAM/image surface (subnets, SGs, AMIs+SSM, profiles, LTs)
        self.network = FakeNetwork(cluster_name=cluster_name,
                                   k8s_version=k8s_version, ip_family=ip_family)

    # ---- fault injection -------------------------------------------------

    def set_capacity(self, capacity_type: str, instance_type: str, zone: str,
                     remaining: int) -> None:
        with self._lock:
            self.capacity_pools[(capacity_type, instance_type, zone)] = remaining

    def clear_capacity(self, capacity_type: str, instance_type: str,
                       zone: str) -> None:
        """Drop a pool's limit entirely (absent = unlimited) — how the
        weather simulator thaws an ICE'd offering back to fair weather."""
        with self._lock:
            self.capacity_pools.pop((capacity_type, instance_type, zone), None)

    def inject_error(self, err: BaseException) -> None:
        with self._lock:
            self.next_error = err

    def _maybe_raise(self):
        if self.next_error is not None:
            err, self.next_error = self.next_error, None
            raise err

    # ---- APIs ------------------------------------------------------------

    def assume_role(self, role_arn: str) -> None:
        """Layer an assumed role onto the session (STS analog: every
        later call runs 'as' this role; the fake just records it so the
        operator's session wiring is observable)."""
        with self._lock:
            self.calls.append(("assume_role", role_arn))
            self.assumed_role_arn = role_arn

    def create_fleet(self, overrides: Sequence[LaunchOverride],
                     tags: Optional[Dict[str, str]] = None) -> "FleetResult":
        """Launch ONE instance from the cheapest available override.

        Returns the instance TOGETHER with every exhausted offering the
        lowest-price walk skipped on the way — real CreateFleet reports
        per-override errors even on success, and the provider feeds them
        into the UnavailableOfferings cache (reference instance.go:348-354
        updateUnavailableOfferingsCache on createFleetOutput.Errors).
        Raises UnfulfillableCapacityError naming every exhausted offering
        when no override has capacity.
        """
        with self._lock:
            self.calls.append(("create_fleet", tuple(o.offering for o in overrides)))
            self._maybe_raise()
            ice: List[Offering] = []
            for o in sorted(overrides, key=lambda o: o.price):
                remaining = self.capacity_pools.get(o.offering)
                if remaining is not None and remaining <= 0:
                    ice.append(o.offering)
                    continue
                if remaining is not None:
                    self.capacity_pools[o.offering] = remaining - 1
                n = next(self._ids)
                ip = (f"2600:1f14:73::{n:x}"
                      if self.network.ip_family == "ipv6"
                      else f"10.0.{(n >> 8) & 0xff}.{n & 0xff}")
                inst = CloudInstance(
                    id=f"i-{n:08x}", instance_type=o.instance_type,
                    zone=o.zone, capacity_type=o.capacity_type,
                    launch_time=self.clock.now(), price=o.price,
                    tags=dict(tags or {}), private_ip=ip)
                self.instances[inst.id] = inst
                return FleetResult(instance=inst, ice=ice)
            raise UnfulfillableCapacityError(offerings=ice or [o.offering for o in overrides])

    def describe_instances(self, ids: Sequence[str]) -> List[CloudInstance]:
        with self._lock:
            self.calls.append(("describe_instances", tuple(ids)))
            self._maybe_raise()
            return [self.instances[i] for i in ids if i in self.instances]

    def list_instances(self, include_terminated: bool = False) -> List[CloudInstance]:
        with self._lock:
            self.calls.append(("list_instances", ()))
            self._maybe_raise()
            return [i for i in self.instances.values()
                    if include_terminated or i.state not in ("terminated",)]

    def peek_instances(self) -> List[CloudInstance]:
        """Side-effect-free running-instance snapshot for observers (the
        weather simulator's storm targeting): no call recording and no
        injected-error consumption — a chaos observer must never race a
        controller for a test-injected fault (same contract as
        liveness_probe)."""
        with self._lock:
            return [i for i in self.instances.values()
                    if i.state == "running"]

    def liveness_probe(self) -> None:
        """Side-effect-free connectivity check for health endpoints: no
        call recording, no injected-error consumption (a /healthz poll must
        never race a controller for a test-injected fault)."""
        with self._lock:
            pass

    def create_tags(self, instance_id: str, tags: Dict[str, str]) -> None:
        """Merge tags onto a live instance (EC2 CreateTags analog; consumed
        by the post-registration tagging controller)."""
        with self._lock:
            self.calls.append(("create_tags", (instance_id, tuple(sorted(tags.items())))))
            self._maybe_raise()
            inst = self.instances.get(instance_id)
            if inst is None or inst.state == "terminated":
                raise NotFoundError(f"instance not found: {instance_id}")
            inst.tags.update(tags)

    def terminate_instances(self, ids: Sequence[str]) -> List[str]:
        """Terminate; unknown ids raise NotFoundError (callers treat it as
        already-gone, reference errors.go not-found taxonomy)."""
        with self._lock:
            self.calls.append(("terminate_instances", tuple(ids)))
            self._maybe_raise()
            missing = [i for i in ids if i not in self.instances]
            if missing:
                raise NotFoundError(f"instance(s) not found: {missing}")
            out = []
            for i in ids:
                inst = self.instances[i]
                if inst.state != "terminated":
                    inst.state = "terminated"
                    # freed pool capacity returns to the market
                    key = (inst.capacity_type, inst.instance_type, inst.zone)
                    if key in self.capacity_pools:
                        self.capacity_pools[key] += 1
                out.append(i)
            return out

    def tag_instance(self, instance_id: str, tags: Dict[str, str]) -> None:
        with self._lock:
            self.calls.append(("tag_instance", (instance_id, tuple(sorted(tags)))))
            self._maybe_raise()
            inst = self.instances.get(instance_id)
            if inst is None:
                raise NotFoundError(f"instance not found: {instance_id}")
            inst.tags.update(tags)

    def reset(self) -> None:
        with self._lock:
            self.instances.clear()
            self.capacity_pools.clear()
            self.next_error = None
            self.calls.clear()
            self.network.reset()
