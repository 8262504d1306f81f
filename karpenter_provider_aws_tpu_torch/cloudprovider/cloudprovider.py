"""The CloudProvider plugin boundary.

Mirror of the reference's six-method seam between the core scheduler and
the cloud (reference pkg/cloudprovider/cloudprovider.go:56-212): Create,
Delete, Get, List, GetInstanceTypes, IsDrifted (+ LivenessProbe). This is
the boundary the TPU solver hides behind — the provisioner's NodePlan
becomes NodeClaims, and each claim's launch resolves here.

Launch semantics mirror the reference instance provider
(pkg/providers/instance/instance.go):
- capacity type = spot iff the claim allows spot and a spot offering
  exists (instance.go:356-372),
- spot overrides pricier than the cheapest on-demand are dropped
  (instance.go:413-437),
- metal/GPU/accelerator types are dropped when a generic type also fits
  and the claim doesn't ask for them (instance.go:439-463),
- overrides are the (type x zone) cross-product sorted by price, capped at
  60 types; the fleet picks the cheapest available pool,
- insufficient-capacity errors feed the UnavailableOfferings cache
  (instance.go:348-354) before propagating,
- launches coalesce through the request batcher (35 ms idle window,
  reference batcher/createfleet.go:70-72).
"""

from __future__ import annotations

import hashlib
import json
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..apis import wellknown as wk
from ..apis.objects import (WINDOWS_BUILD, NodeClaim, NodeClaimPhase,
                            NodeClass, NodePool)
from ..apis.requirements import Requirements
from ..apis.resources import vec_to_resources
from ..batcher import Batcher, BatcherOptions
from ..cache.unavailable import UnavailableOfferings
from ..cloud.fake import CloudInstance, FakeCloud, LaunchOverride, parse_instance_id
from ..errors import NotFoundError, UnfulfillableCapacityError
from ..events import Recorder
from ..lattice.tensors import Lattice
from ..ops.masks import compile_masks
from ..utils.clock import Clock

MAX_INSTANCE_TYPES = 60            # instance.go:50
FLEXIBILITY_THRESHOLD = 5          # instance.go:52 (OD-fallback warning)


# bump when the hash FORMULA changes (fields added/removed), so pre-upgrade
# claims are re-stamped instead of mass-drifting the fleet (same mechanism as
# provisioning.NODEPOOL_HASH_VERSION; reference karpenter.k8s.aws/
# ec2nodeclass-hash-version migration). v2: + instance_store_policy
NODECLASS_HASH_VERSION = "v2"


def nodeclass_hash(nc: NodeClass) -> str:
    """Static spec hash for drift detection (reference
    pkg/apis/v1beta1/ec2nodeclass.go:338-344 Hash + drift.go:137-151)."""
    payload = json.dumps({
        "ami_family": nc.ami_family, "user_data": nc.user_data, "role": nc.role,
        "instance_profile": nc.instance_profile, "tags": sorted(nc.tags.items()),
        "metadata_options": vars(nc.metadata_options),
        "block_device_mappings": nc.block_device_mappings,
        "instance_store_policy": nc.instance_store_policy,
        "detailed_monitoring": nc.detailed_monitoring,
        "associate_public_ip": nc.associate_public_ip,
    }, sort_keys=True, default=str)
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


@dataclass
class OfferingView:
    zone: str
    capacity_type: str
    price: float
    available: bool


@dataclass
class InstanceType:
    """Per-type view the scheduler-facing API returns (reference
    pkg/providers/instancetype/types.go:56-66 {Name, Requirements,
    Offerings, Capacity, Overhead})."""

    name: str
    labels: Dict[str, str]
    capacity: Dict[str, float]
    allocatable: Dict[str, float]
    offerings: List[OfferingView] = field(default_factory=list)


class CloudProvider:
    """The plugin seam; backed by the pluggable cloud (FakeCloud by default)."""

    name = "tpu-sim"

    def __init__(self, lattice: Lattice, cloud: FakeCloud,
                 unavailable: UnavailableOfferings,
                 recorder: Optional[Recorder] = None,
                 clock: Optional[Clock] = None,
                 node_classes: Optional[Dict[str, NodeClass]] = None,
                 batch_options: Optional[BatcherOptions] = None,
                 subnets=None, launch_templates=None, version=None):
        self.lattice = lattice
        self.cloud = cloud
        self.unavailable = unavailable
        self.recorder = recorder or Recorder(clock)
        self.clock = clock or Clock()
        self.node_classes: Dict[str, NodeClass] = node_classes or {
            "default": NodeClass(name="default", role="KarpenterNodeRole-sim")}
        # optional domain providers (reference pkg/providers/*); absent in
        # bare-solver setups, wired by the operator
        self.subnets = subnets
        self.launch_templates = launch_templates
        self.version = version
        self._launch_batcher: Batcher = Batcher(
            self._launch_batch,
            batch_options or BatcherOptions(idle_seconds=0.005),
            clock=self.clock)
        self._terminate_batcher: Batcher = Batcher(
            self._terminate_batch,
            batch_options or BatcherOptions(idle_seconds=0.005),
            clock=self.clock)
        self._lock = threading.Lock()

    # ---- Create ----------------------------------------------------------

    def create(self, claim: NodeClaim) -> NodeClaim:
        """Launch capacity satisfying the claim's requirements
        (cloudprovider.go:80-109 → instance.go:84-244): resolve the
        NodeClass, ensure launch templates, cross overrides with zonal
        subnets, launch, book in-flight IPs."""
        nc = self.node_classes.get(claim.node_class_ref)
        lts_by_arch = {}
        if self.launch_templates is not None and nc is not None:
            k8s_version = self.version.get() if self.version is not None else "1.29"
            # kubelet cluster-DNS: the pool's kubelet block wins; else the
            # kube-dns service IP discovered best-effort at startup
            # (reference operator.go:125-132; ipv6 suite exercises both)
            dns = claim.cluster_dns or self.cloud.network.kube_dns_ip
            for lt in self.launch_templates.ensure_all(nc, k8s_version,
                                                       cluster_dns=dns):
                img = self.cloud.network.images.get(lt.image_id)
                if img is not None:
                    lts_by_arch[img.arch] = lt
        zonal_subnets = None
        if self.subnets is not None and nc is not None:
            zonal_subnets = self.subnets.zonal_subnets_for_launch(nc)
        overrides = self._resolve_overrides(claim)
        if zonal_subnets is not None:
            # zones with no resolvable subnet cannot host a launch
            # (instance.go:306-346 overrides x zonal subnets cross-product)
            overrides = [o for o in overrides if o.zone in zonal_subnets]
        if not overrides:
            raise UnfulfillableCapacityError(offerings=[])
        if (overrides[0].capacity_type == wk.CAPACITY_TYPE_SPOT
                and len({o.instance_type for o in overrides}) < FLEXIBILITY_THRESHOLD):
            self.recorder.publish(
                "Warning", "SpotFlexibilityLow", "NodeClaim", claim.name,
                f"launching spot with {len({o.instance_type for o in overrides})} instance "
                f"types; >= {FLEXIBILITY_THRESHOLD} recommended for reliable fallback")
        try:
            fleet = self._launch_batcher.add(tuple(overrides))
        except UnfulfillableCapacityError as e:
            self.unavailable.mark_unavailable_for_error(e)
            self.recorder.publish("Warning", "InsufficientCapacity", "NodeClaim",
                                  claim.name, str(e))
            raise
        instance = fleet.instance
        # a successful fleet still reports the exhausted offerings its
        # lowest-price walk skipped; cache them so the next solve masks
        # them out (reference instance.go:348-354)
        for ct, it, zone in fleet.ice:
            self.unavailable.mark_unavailable("fleet-error", ct, it, zone)
        if zonal_subnets is not None and instance.zone in zonal_subnets:
            subnet = zonal_subnets[instance.zone]
            self.subnets.update_inflight_ips(subnet.id)
            instance.tags["subnet-id"] = subnet.id
            instance.subnet_id = subnet.id
        arch = self.lattice.labels[self.lattice.name_to_idx[instance.instance_type]].get(
            wk.LABEL_ARCH, "amd64")
        lt = lts_by_arch.get(arch)
        if lt is not None:
            instance.tags["launch-template"] = lt.name
            instance.image_id = lt.image_id
            instance.security_group_ids = tuple(lt.security_group_ids)
            claim.image_id = lt.image_id
        return self._instance_to_claim(instance, claim)

    def _launch_batch(self, batch: List[Tuple[LaunchOverride, ...]]) -> List[object]:
        """Coalesced launch: one locked pass over the fake fleet API
        (reference coalesces N single-instance requests into one CreateFleet
        with capacity N and splits results back, createfleet.go:67-130)."""
        out: List[object] = []
        for overrides in batch:
            try:
                out.append(self.cloud.create_fleet(list(overrides)))
            except BaseException as e:
                out.append(e)
        return out

    def _resolve_overrides(self, claim: NodeClaim) -> List[LaunchOverride]:
        lat = self.lattice
        reqs = claim.scheduling_requirements()
        masks = compile_masks(reqs, lat, extra_labels=claim.labels)
        offer = (lat.available
                 & masks.type_mask[:, None, None]
                 & masks.zone_mask[None, :, None]
                 & masks.cap_mask[None, None, :]
                 & self.unavailable.mask(lat))
        if not offer.any():
            return []
        # capacity type: spot iff allowed and offered (instance.go:356-372)
        spot_ci = lat.capacity_types.index(wk.CAPACITY_TYPE_SPOT) if wk.CAPACITY_TYPE_SPOT in lat.capacity_types else -1
        od_ci = lat.capacity_types.index(wk.CAPACITY_TYPE_ON_DEMAND) if wk.CAPACITY_TYPE_ON_DEMAND in lat.capacity_types else -1
        use_spot = spot_ci >= 0 and offer[:, :, spot_ci].any()
        ci = spot_ci if use_spot else od_ci
        if ci < 0:
            return []
        # price filter: spot overrides pricier than the cheapest on-demand
        # offering are never worth launching (instance.go:413-437)
        price_cap = np.inf
        if use_spot and od_ci >= 0 and offer[:, :, od_ci].any():
            price_cap = float(np.where(offer[:, :, od_ci], lat.price[:, :, od_ci], np.inf).min())
        # exotic-type filter (instance.go:439-463): drop metal/gpu/accelerator
        # types when a generic type fits and the claim doesn't require them,
        # unless minValues forbids narrowing (instance.go:86-89)
        tmask = offer[:, :, ci].any(axis=1)
        has_min_values = any(r.min_values is not None for r in reqs.requirements)
        if not has_min_values:
            wants_gpu = any(claim.resource_requests.get(r, 0) > 0
                            for r in ("nvidia.com/gpu", "aws.amazon.com/neuron"))
            generic = np.array([
                lat.specs[t].gpu_count == 0 and lat.specs[t].accelerator_count == 0
                and lat.specs[t].size != "metal"
                for t in range(lat.T)])
            if not wants_gpu and (tmask & generic).any():
                tmask = tmask & generic
        overrides: List[LaunchOverride] = []
        for t in np.nonzero(tmask)[0]:
            for z in np.nonzero(offer[t, :, ci])[0]:
                p = float(lat.price[t, z, ci])
                if p > price_cap:
                    continue
                overrides.append(LaunchOverride(
                    instance_type=lat.names[t], zone=lat.zones[z],
                    capacity_type=lat.capacity_types[ci], price=p))
        overrides.sort(key=lambda o: o.price)
        # cap the *type* flexibility at 60 like CreateFleet (instance.go:50)
        seen_types: Dict[str, None] = {}
        capped: List[LaunchOverride] = []
        for o in overrides:
            if o.instance_type not in seen_types and len(seen_types) >= MAX_INSTANCE_TYPES:
                continue
            seen_types.setdefault(o.instance_type, None)
            capped.append(o)
        return capped

    def _instance_to_claim(self, instance: CloudInstance, claim: NodeClaim) -> NodeClaim:
        """instance → NodeClaim status (cloudprovider.go:282-325)."""
        lat = self.lattice
        ti = lat.name_to_idx[instance.instance_type]
        claim.provider_id = instance.provider_id
        claim.internal_ip = instance.private_ip
        claim.instance_type = instance.instance_type
        claim.zone = instance.zone
        claim.capacity_type = instance.capacity_type
        claim.capacity = vec_to_resources(lat.capacity[ti])
        claim.allocatable = vec_to_resources(lat.alloc[ti])
        if claim.max_pods is not None:
            # the pool's kubelet maxPods caps pod density below the
            # ENI-derived number — applied HERE so the claim never exists
            # in a LAUNCHED state with the unclamped value visible
            for res in (claim.capacity, claim.allocatable):
                if "pods" in res:
                    res["pods"] = min(res["pods"], float(claim.max_pods))
        claim.labels = {
            **lat.labels[ti],
            **claim.labels,
            wk.LABEL_INSTANCE_TYPE: instance.instance_type,
            wk.LABEL_ZONE: instance.zone,
            wk.LABEL_CAPACITY_TYPE: instance.capacity_type,
            wk.LABEL_NODEPOOL: claim.node_pool,
        }
        if claim.labels.get(wk.LABEL_OS) == "windows":
            # every windows node carries the AMI's build (well-known
            # node.kubernetes.io/windows-build, reference labels.go
            # v1.LabelWindowsBuild) — keyed on the claim's resolved OS so
            # the stamp can never diverge from what the solver advertised
            claim.labels.setdefault(wk.LABEL_WINDOWS_BUILD, WINDOWS_BUILD)
        nc = self.node_classes.get(claim.node_class_ref)
        if nc is not None:
            claim.annotations[wk.ANNOTATION_NODECLASS_HASH] = nodeclass_hash(nc)
            claim.annotations[wk.ANNOTATION_NODECLASS_HASH_VERSION] = \
                NODECLASS_HASH_VERSION
        claim.phase = NodeClaimPhase.LAUNCHED
        claim.launched_at = self.clock.now()
        return claim

    # ---- Delete / Get / List --------------------------------------------

    def delete(self, claim: NodeClaim) -> None:
        if claim.provider_id is None:
            raise NotFoundError(f"claim {claim.name} has no provider id")
        iid = parse_instance_id(claim.provider_id)
        self._terminate_batcher.add(iid)

    def _terminate_batch(self, ids: List[str]) -> List[object]:
        """Coalesced terminate (reference batcher/terminateinstances.go)."""
        results: List[object] = []
        known = {i.id for i in self.cloud.list_instances(include_terminated=True)}
        present = [i for i in ids if i in known]
        if present:
            self.cloud.terminate_instances(present)
        for i in ids:
            results.append(None if i in known else NotFoundError(f"instance not found: {i}"))
        return results

    def get(self, provider_id: str) -> CloudInstance:
        iid = parse_instance_id(provider_id)
        found = self.cloud.describe_instances([iid])
        if not found or found[0].state == "terminated":
            raise NotFoundError(f"instance not found: {iid}")
        return found[0]

    def list_instances(self) -> List[CloudInstance]:
        return self.cloud.list_instances()

    # ---- GetInstanceTypes ------------------------------------------------

    def get_instance_types(self, pool: NodePool) -> List[InstanceType]:
        """The scheduler's lattice feed (cloudprovider.go:149-169), with
        per-offering availability reflecting the ICE cache."""
        lat = self.lattice
        reqs = pool.scheduling_requirements()
        masks = compile_masks(reqs, lat, extra_labels=pool.labels)
        ice = self.unavailable.mask(lat)
        out: List[InstanceType] = []
        for t in np.nonzero(masks.type_mask)[0]:
            offerings = []
            for z in range(lat.Z):
                for c in range(lat.C):
                    if not lat.available[t, z, c]:
                        continue
                    offerings.append(OfferingView(
                        zone=lat.zones[z], capacity_type=lat.capacity_types[c],
                        price=float(lat.price[t, z, c]),
                        available=bool(ice[t, z, c] and masks.zone_mask[z] and masks.cap_mask[c])))
            out.append(InstanceType(
                name=lat.names[t], labels=dict(lat.labels[t]),
                capacity=vec_to_resources(lat.capacity[t]),
                allocatable=vec_to_resources(lat.alloc[t]),
                offerings=offerings))
        return out

    # ---- IsDrifted -------------------------------------------------------

    def is_drifted(self, claim: NodeClaim) -> Optional[str]:
        """Drift reasons (reference pkg/cloudprovider/drift.go:44-151):
        NodeClassDrift on static-hash mismatch (checked first to save the
        live lookups), InstanceDrift when the backing instance disappeared,
        then live AMI/subnet/SG comparison of the instance's actual launch
        materialization against the NodeClass's currently-resolved status
        (drift.go:73-135). Each live check is skipped when either side is
        unknown — the reference treats undiscovered state as an error, not
        as drift."""
        nc = self.node_classes.get(claim.node_class_ref)
        if nc is not None:
            have = claim.annotations.get(wk.ANNOTATION_NODECLASS_HASH)
            have_ver = claim.annotations.get(
                wk.ANNOTATION_NODECLASS_HASH_VERSION)
            if have is not None and have_ver != NODECLASS_HASH_VERSION:
                # the hash formula changed between controller versions:
                # re-stamp under the new formula instead of treating the
                # formula change as drift (it would roll the whole fleet)
                claim.annotations[wk.ANNOTATION_NODECLASS_HASH] = \
                    nodeclass_hash(nc)
                claim.annotations[wk.ANNOTATION_NODECLASS_HASH_VERSION] = \
                    NODECLASS_HASH_VERSION
            elif have is not None and have != nodeclass_hash(nc):
                return "NodeClassDrift"
        if claim.provider_id is not None:
            try:
                inst = self.get(claim.provider_id)
            except NotFoundError:
                return "InstanceDrift"
            if nc is not None:
                if inst.image_id and nc.status_amis:
                    # AMIs map to instance types by arch (drift.go:91-96):
                    # an amd64 node must not drift because the arm64
                    # default AMI rolled
                    arch = self.lattice.labels[
                        self.lattice.name_to_idx[inst.instance_type]].get(
                        wk.LABEL_ARCH, "amd64")
                    allowed = {a["id"] for a in nc.status_amis
                               if a.get("arch") in (None, arch)}
                    if allowed and inst.image_id not in allowed:
                        return "AMIDrift"
                if inst.subnet_id and nc.status_subnets:
                    if inst.subnet_id not in {s["id"] for s in nc.status_subnets}:
                        return "SubnetDrift"
                if inst.security_group_ids and nc.status_security_groups:
                    if (set(inst.security_group_ids)
                            != {g["id"] for g in nc.status_security_groups}):
                        return "SecurityGroupDrift"
        return None

    def liveness_probe(self) -> bool:
        try:
            self.cloud.list_instances()
            return True
        except Exception:
            return False
