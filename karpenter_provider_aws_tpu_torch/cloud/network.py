"""Fake cloud network / IAM / image / template surface.

Mirror of the reference's non-EC2-fleet fakes (reference pkg/fake: EKS,
SSM, IAM fakes + subnet/SG/image describe APIs): subnets with free-IP
accounting, security groups, machine images with SSM alias parameters,
IAM instance profiles, and launch templates. Seeded with a plausible
default VPC so the provider layer works out of the box; tests override.
"""

from __future__ import annotations

import itertools
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from ..errors import AlreadyExistsError, NotFoundError


@dataclass
class Subnet:
    id: str
    zone: str
    cidr: str
    available_ips: int
    tags: Dict[str, str] = field(default_factory=dict)
    # "availability-zone" | "local-zone" (DescribeAvailabilityZones
    # ZoneType; the reference's localzone suite selects zones by it)
    zone_type: str = "availability-zone"


@dataclass
class SecurityGroup:
    id: str
    name: str
    tags: Dict[str, str] = field(default_factory=dict)


@dataclass
class Image:
    id: str
    name: str
    arch: str                  # amd64 | arm64
    creation_date: float
    deprecated: bool = False
    tags: Dict[str, str] = field(default_factory=dict)
    requirements: Dict[str, str] = field(default_factory=dict)  # e.g. gpu-only images


@dataclass
class InstanceProfile:
    name: str
    role: str
    tags: Dict[str, str] = field(default_factory=dict)


@dataclass
class LaunchTemplate:
    id: str
    name: str
    image_id: str
    user_data: str
    security_group_ids: Tuple[str, ...]
    instance_profile: str
    tags: Dict[str, str] = field(default_factory=dict)
    metadata_options: Dict[str, str] = field(default_factory=dict)
    block_device_mappings: Tuple = ()


def _match_tags(obj_tags: Dict[str, str], want: Dict[str, str]) -> bool:
    for k, v in want.items():
        if v == "*":
            if k not in obj_tags:
                return False
        elif obj_tags.get(k) != v:
            return False
    return True


class FakeNetwork:
    """Attached to FakeCloud as `.network`."""

    def __init__(self, zones: Optional[Sequence[str]] = None,
                 cluster_name: str = "sim", k8s_version: str = "1.29",
                 ip_family: str = "ipv4"):
        self._lock = threading.RLock()
        self._ids = itertools.count(1)
        self.k8s_version = k8s_version
        self.cluster_endpoint = f"https://{cluster_name}.sim.local"
        # single-stack IP family (reference test/suites/ipv6): the kube-dns
        # service IP the operator discovers best-effort
        # (operator.go:125-132) and the address family of launched nodes
        assert ip_family in ("ipv4", "ipv6"), ip_family
        self.ip_family = ip_family
        self.kube_dns_ip = ("fd30:7061:6b65:74::a" if ip_family == "ipv6"
                           else "10.100.0.10")
        self.subnets: Dict[str, Subnet] = {}
        self.security_groups: Dict[str, SecurityGroup] = {}
        self.images: Dict[str, Image] = {}
        self.instance_profiles: Dict[str, InstanceProfile] = {}
        self.launch_templates: Dict[str, LaunchTemplate] = {}
        self.ssm_parameters: Dict[str, str] = {}
        discovery = {f"kubernetes.io/cluster/{cluster_name}": "owned"}
        from ..lattice import catalog as cat
        if zones is None:
            zones = cat.ZONES  # incl. the local zone (its subnet is tagged)
        for i, z in enumerate(zones):
            sid = f"subnet-{i+1:04d}"
            self.subnets[sid] = Subnet(
                id=sid, zone=z, cidr=f"10.0.{i}.0/24", available_ips=250,
                tags=dict(discovery),
                zone_type=cat.ZONE_TYPES.get(z, "availability-zone"))
        for i, name in enumerate(("default", "nodes")):
            gid = f"sg-{i+1:04d}"
            self.security_groups[gid] = SecurityGroup(id=gid, name=name,
                                                      tags=dict(discovery))
        # default AMIs per family x arch, exposed via SSM alias parameters
        # (reference amifamily/ami.go:136-181 SSM default-AMI discovery).
        # Keys come from each family strategy's own
        # default_ami_ssm_parameters() so the fake and the resolver can
        # never drift on the parameter paths. Deferred import: amifamily
        # imports this module for the Image type.
        from ..providers.amifamily import AMI_FAMILIES
        t = 1_000.0
        for fam_name, fam in AMI_FAMILIES.items():
            for arch, path in fam.default_ami_ssm_parameters(k8s_version).items():
                slug = fam_name.lower()
                iid = f"ami-{slug}-{arch}"
                if iid not in self.images:
                    self.images[iid] = Image(id=iid, name=f"{slug}-{arch}-v{k8s_version}",
                                             arch=arch, creation_date=t)
                self.ssm_parameters[path] = iid

    # ---- describe APIs ---------------------------------------------------

    def describe_subnets(self, tags: Optional[Dict[str, str]] = None,
                         ids: Sequence[str] = ()) -> List[Subnet]:
        with self._lock:
            out = []
            for s in self.subnets.values():
                if ids and s.id not in ids:
                    continue
                if tags and not _match_tags(s.tags, tags):
                    continue
                out.append(s)
            return out

    def describe_security_groups(self, tags: Optional[Dict[str, str]] = None,
                                 ids: Sequence[str] = (),
                                 names: Sequence[str] = ()) -> List[SecurityGroup]:
        with self._lock:
            out = []
            for g in self.security_groups.values():
                if ids and g.id not in ids:
                    continue
                if names and g.name not in names:
                    continue
                if tags and not _match_tags(g.tags, tags):
                    continue
                out.append(g)
            return out

    def describe_images(self, tags: Optional[Dict[str, str]] = None,
                        ids: Sequence[str] = (),
                        names: Sequence[str] = ()) -> List[Image]:
        with self._lock:
            out = []
            for im in self.images.values():
                if ids and im.id not in ids:
                    continue
                if names and im.name not in names:
                    continue
                if tags and not _match_tags(im.tags, tags):
                    continue
                out.append(im)
            return out

    def get_parameter(self, name: str) -> str:
        with self._lock:
            if name not in self.ssm_parameters:
                raise NotFoundError(f"ssm parameter not found: {name}")
            return self.ssm_parameters[name]

    # ---- IAM -------------------------------------------------------------

    def create_instance_profile(self, name: str, role: str,
                                tags: Optional[Dict[str, str]] = None) -> InstanceProfile:
        with self._lock:
            if name in self.instance_profiles:
                raise AlreadyExistsError(f"instance profile exists: {name}")
            p = InstanceProfile(name=name, role=role, tags=dict(tags or {}))
            self.instance_profiles[name] = p
            return p

    def get_instance_profile(self, name: str) -> InstanceProfile:
        with self._lock:
            if name not in self.instance_profiles:
                raise NotFoundError(f"instance profile not found: {name}")
            return self.instance_profiles[name]

    def delete_instance_profile(self, name: str) -> None:
        with self._lock:
            if name not in self.instance_profiles:
                raise NotFoundError(f"instance profile not found: {name}")
            del self.instance_profiles[name]

    # ---- launch templates --------------------------------------------------

    def create_launch_template(self, lt: LaunchTemplate) -> LaunchTemplate:
        with self._lock:
            if any(x.name == lt.name for x in self.launch_templates.values()):
                raise AlreadyExistsError(f"launch template exists: {lt.name}")
            lt.id = f"lt-{next(self._ids):06d}"
            self.launch_templates[lt.id] = lt
            return lt

    def describe_launch_templates(self, names: Sequence[str] = (),
                                  tags: Optional[Dict[str, str]] = None) -> List[LaunchTemplate]:
        with self._lock:
            out = []
            for lt in self.launch_templates.values():
                if names and lt.name not in names:
                    continue
                if tags and not _match_tags(lt.tags, tags):
                    continue
                out.append(lt)
            return out

    def delete_launch_template(self, name: str) -> None:
        with self._lock:
            found = [i for i, lt in self.launch_templates.items() if lt.name == name]
            if not found:
                raise NotFoundError(f"launch template not found: {name}")
            for i in found:
                del self.launch_templates[i]

    def reset(self) -> None:
        with self._lock:
            self.instance_profiles.clear()
            self.launch_templates.clear()
