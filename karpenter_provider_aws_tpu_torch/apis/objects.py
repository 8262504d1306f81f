"""CRD-equivalent object model.

Python dataclass mirrors of the API types the reference defines or consumes:
- Pod scheduling surface (requests, nodeSelector/affinity, tolerations,
  topology spread, pod anti-affinity) — core scheduling semantics per
  reference website concepts/scheduling.md:23-35,312-446.
- NodePool (core CRD: pkg/apis/crds/karpenter.sh_nodepools.yaml) — template
  labels/taints/requirements, limits, weight, disruption policy + budgets.
- NodeClass (EC2NodeClass analog: pkg/apis/v1beta1/ec2nodeclass.go:28-119) —
  subnet/SG/AMI selector terms, AMI family, userdata, metadata options.
- NodeClaim (core CRD: karpenter.sh_nodeclaims.yaml) — the launch contract
  between scheduler and cloud provider, with lifecycle status.
- Node — the registered machine mirror used by cluster state.
"""

from __future__ import annotations

import enum
import time
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from .requirements import Operator, Requirement, Requirements
from .resources import resources_to_vec
from . import wellknown


# ---------------------------------------------------------------------------
# Taints / tolerations (k8s semantics, used by scheduling.md:312+ behaviors)
# ---------------------------------------------------------------------------

class TaintEffect(str, enum.Enum):
    NO_SCHEDULE = "NoSchedule"
    PREFER_NO_SCHEDULE = "PreferNoSchedule"
    NO_EXECUTE = "NoExecute"


@dataclass(frozen=True)
class Taint:
    key: str
    value: str = ""
    effect: TaintEffect = TaintEffect.NO_SCHEDULE


@dataclass(frozen=True)
class Toleration:
    key: str = ""            # empty key + Exists tolerates everything
    operator: str = "Equal"  # Equal | Exists
    value: str = ""
    effect: Optional[TaintEffect] = None  # None tolerates all effects

    def tolerates(self, taint: Taint) -> bool:
        if self.effect is not None and self.effect != taint.effect:
            return False
        if self.operator == "Exists":
            return self.key == "" or self.key == taint.key
        return self.key == taint.key and self.value == taint.value


def tolerates_all(tolerations: Sequence[Toleration], taints: Sequence[Taint]) -> bool:
    """A pod schedules onto a node iff every NoSchedule/NoExecute taint is tolerated."""
    for t in taints:
        if t.effect == TaintEffect.PREFER_NO_SCHEDULE:
            continue
        if not any(tol.tolerates(t) for tol in tolerations):
            return False
    return True


# ---------------------------------------------------------------------------
# Pod scheduling surface
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TopologySpreadConstraint:
    max_skew: int
    topology_key: str                      # zone / hostname / capacity-type
    when_unsatisfiable: str = "DoNotSchedule"  # or ScheduleAnyway
    # pods counted toward the spread are those matching these labels
    label_selector: Tuple[Tuple[str, str], ...] = ()


@dataclass(frozen=True)
class PodAffinityTerm:
    topology_key: str
    label_selector: Tuple[Tuple[str, str], ...] = ()
    anti: bool = False


@dataclass
class StorageClass:
    """Storage class with zonal allowedTopologies (reference
    scheduling.md:389-398 'Persistent Volume Topology')."""

    name: str
    zones: Tuple[str, ...] = ()            # allowedTopologies; () = any zone
    binding_mode: str = "WaitForFirstConsumer"   # or Immediate
    # CSI driver name. Deprecated in-tree plugins (kubernetes.io/aws-ebs)
    # publish no CSINode attach limits — the reference logs an error and
    # cannot enforce volume limits for them (troubleshooting.md:290-294)
    provisioner: str = "ebs.csi.aws.com"


IN_TREE_PROVISIONERS = frozenset({
    "kubernetes.io/aws-ebs", "kubernetes.io/gce-pd", "kubernetes.io/azure-disk",
})


@dataclass
class PersistentVolumeClaim:
    """A pod's storage claim. ``bound_zone`` is set once a PersistentVolume
    exists (the CSI driver gives it a zonal node-affinity rule); an unbound
    WaitForFirstConsumer claim restricts scheduling to its StorageClass's
    allowed topologies and binds to the zone the pod lands in."""

    name: str
    storage_class: str = ""
    bound_zone: Optional[str] = None


@dataclass(frozen=True)
class PreferredRequirement:
    """preferredDuringSchedulingIgnoredDuringExecution node-affinity term
    (reference scheduling.md:203-206): a soft rule. The scheduler treats it
    as required while possible and relaxes it — lowest weight first — when
    the pod cannot otherwise schedule (the core's preference relaxation)."""

    requirement: Requirement
    weight: int = 1                        # k8s weight 1-100


@dataclass
class PodDisruptionBudget:
    """Voluntary-eviction budget over a labelled pod set (the Kubernetes
    policy/v1 object the reference's drain respects — reference
    concepts/disruption.md:33 "evicting the pods ... to respect PDBs"
    and :112, the `pdb ... prevents pod evictions` Unconsolidatable
    event). Exactly one of max_unavailable / min_available must be set —
    the admission webhook (webhooks.validate_pdb) rejects anything else,
    as Kubernetes does; ClusterState still evaluates the tighter rule
    defensively if an unvalidated object carries both."""

    name: str
    label_selector: Dict[str, str] = field(default_factory=dict)
    max_unavailable: Optional[int] = None
    min_available: Optional[int] = None
    namespace: str = "default"

    def matches(self, pod: "Pod") -> bool:
        if pod.namespace != self.namespace:
            return False
        return all(pod.labels.get(k) == v
                   for k, v in self.label_selector.items())


@dataclass
class Pod:
    name: str
    namespace: str = "default"
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    requests: Dict[str, "str | int | float"] = field(default_factory=dict)
    node_selector: Dict[str, str] = field(default_factory=dict)
    required_affinity: List[Requirement] = field(default_factory=list)  # nodeAffinity required terms
    preferred_affinity: List[PreferredRequirement] = field(default_factory=list)
    tolerations: List[Toleration] = field(default_factory=list)
    topology_spread: List[TopologySpreadConstraint] = field(default_factory=list)
    pod_affinity: List[PodAffinityTerm] = field(default_factory=list)
    volume_claims: List[str] = field(default_factory=list)  # PVC names
    node_name: Optional[str] = None        # bound node (None = pending)
    owner: Optional[str] = None            # controller owner (daemonset detection etc.)
    is_daemonset: bool = False
    priority: int = 0
    deletion_timestamp: Optional[float] = None

    # fields that feed the scheduling-signature cache the solver stores on
    # the pod (solver/problem.py); reassigning any of them drops the cache.
    # In-place mutation of a field's container (pod.requests["cpu"] = ...)
    # is out of contract, as in k8s where pod specs are immutable.
    _SIG_FIELDS = frozenset({
        "labels", "requests", "node_selector", "required_affinity",
        "preferred_affinity", "tolerations", "topology_spread",
        "pod_affinity", "volume_claims"})

    def __setattr__(self, name, value):
        if name in Pod._SIG_FIELDS:
            self.__dict__.pop("_kpat_sig", None)
            self.__dict__.pop("_kpat_selkeys", None)
        object.__setattr__(self, name, value)

    def hard_scheduling_requirements(self) -> Requirements:
        """Required rules only — what can never be relaxed away."""
        reqs = Requirements.from_node_selector(self.node_selector)
        for r in self.required_affinity:
            reqs.add(r)
        return reqs

    def scheduling_requirements(self) -> Requirements:
        reqs = self.hard_scheduling_requirements()
        # preferences are treated as required while possible; the relaxation
        # loop (Solver.solve_relaxed) hands in relaxed Pod copies with the
        # weakest ones removed when the pod cannot otherwise schedule
        for p in self.preferred_affinity:
            reqs.add(p.requirement)
        return reqs

    def request_vec(self) -> np.ndarray:
        return resources_to_vec(self.requests, implicit_pod=True)


def _relax_sequence(pod: "Pod") -> List[Tuple[str, int]]:
    """Droppable soft constraints in drop order: preferred node-affinity
    terms lowest-weight-first (scheduling.md:203-206), then ScheduleAnyway
    topology spreads (advisory skew, scheduling.md:322-334)."""
    prefs = sorted(range(len(pod.preferred_affinity)),
                   key=lambda i: (pod.preferred_affinity[i].weight, i))
    seq: List[Tuple[str, int]] = [("pref", i) for i in prefs]
    seq += [("spread", i) for i, c in enumerate(pod.topology_spread)
            if c.when_unsatisfiable == "ScheduleAnyway"]
    return seq


def relaxation_depth(pod: Pod) -> int:
    """How many relaxation steps this pod supports (0 = nothing soft)."""
    return len(_relax_sequence(pod))


def relax_pod(pod: Pod, level: int) -> Pod:
    """Pod copy with its ``level`` weakest soft constraints removed."""
    if level <= 0:
        return pod
    import dataclasses
    dropped = _relax_sequence(pod)[:level]
    dp = {i for kind, i in dropped if kind == "pref"}
    ds = {i for kind, i in dropped if kind == "spread"}
    return dataclasses.replace(
        pod,
        preferred_affinity=[p for i, p in enumerate(pod.preferred_affinity)
                            if i not in dp],
        topology_spread=[c for i, c in enumerate(pod.topology_spread)
                         if i not in ds])


# ---------------------------------------------------------------------------
# NodePool (core CRD)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class DisruptionBudget:
    """Rate limit on concurrent voluntary disruptions
    (CRD karpenter.sh_nodepools.yaml:55-100)."""
    nodes: str = "10%"                      # count or percentage
    schedule: Optional[str] = None          # cron; None = always active
    duration: Optional[float] = None        # seconds the schedule window lasts
    reasons: Tuple[str, ...] = ()           # empty = all reasons


@dataclass
class NodePoolDisruption:
    consolidation_policy: str = "WhenUnderutilized"  # or WhenEmpty
    consolidate_after: Optional[float] = None        # seconds; None = Never
    expire_after: Optional[float] = None             # seconds; None = Never
    budgets: List[DisruptionBudget] = field(default_factory=lambda: [DisruptionBudget()])


@dataclass
class KubeletSpec:
    """The NodePool kubelet block (reference nodepools CRD
    spec.template.spec.kubelet): per-pool kubelet knobs that change node
    allocatable. ``max_pods`` caps the pods axis below the ENI-derived
    density (the reference's pod-dense scale test pins maxPods: 110).

    Three consumers apply the cap and must stay in lockstep when a knob
    is added here: the solve tensors (problem.np_alloc_cap), limit
    accounting (provisioning _enforce_limits via ``clamp_pods``), and
    the claim fill (cloudprovider.create via NodeClaim.max_pods)."""

    max_pods: Optional[int] = None
    # kubelet --cluster-dns override (the reference ipv6 suite sets an
    # IPv6 kube-dns here; discovery is the operator-side default,
    # reference operator.go:125-132)
    cluster_dns: Optional[str] = None

    def clamp_pods(self, pods_value: float) -> float:
        if self.max_pods is None:
            return pods_value
        return min(pods_value, float(self.max_pods))


@dataclass
class NodePool:
    name: str
    weight: int = 0                                   # higher tried first (nodepools.md:161-163)
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    taints: List[Taint] = field(default_factory=list)
    startup_taints: List[Taint] = field(default_factory=list)
    requirements: List[Requirement] = field(default_factory=list)
    node_class_ref: str = "default"
    limits: Dict[str, "str | int | float"] = field(default_factory=dict)  # cpu/memory ceilings
    disruption: NodePoolDisruption = field(default_factory=NodePoolDisruption)
    kubelet: Optional[KubeletSpec] = None  # per-pool allocatable knobs
    # set only on VIRTUAL pools the problem builder materializes for
    # custom-key label assignments (reference scheduling.md:536-556, the
    # Exists-operator workload-segregation technique): ``base_name`` is
    # the real pool (limits/budgets/hash roll up there) and
    # ``custom_labels`` the label values this variant's nodes carry.
    base_name: Optional[str] = None
    custom_labels: Dict[str, str] = field(default_factory=dict)
    # status: live committed usage (registered nodes + in-flight claims),
    # quantity strings per axis — the reference NodePool's
    # status.resources. Controller-owned; outside the template hash
    # (controllers/provisioning.py nodepool_hash) so status refreshes
    # never read as drift.
    status_resources: Dict[str, str] = field(default_factory=dict)

    def scheduling_requirements(self) -> Requirements:
        reqs = Requirements.from_labels(self.labels)
        for r in self.requirements:
            reqs.add(r)
        # a virtual variant's nodes still carry the REAL pool's name label
        reqs.add(Requirement(wellknown.LABEL_NODEPOOL, Operator.IN,
                             (self.base_name or self.name,)))
        return reqs

    def limits_vec(self) -> Optional[np.ndarray]:
        if not self.limits:
            return None
        return resources_to_vec(self.limits)


# ---------------------------------------------------------------------------
# NodeClass (provider CRD analog)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class NodeClassSelectorTerm:
    """Tag/id/name selector term (ec2nodeclass.go subnet/SG/AMI selector terms)."""
    tags: Tuple[Tuple[str, str], ...] = ()
    id: Optional[str] = None
    name: Optional[str] = None


@dataclass
class MetadataOptions:
    http_endpoint: str = "enabled"
    http_protocol_ipv6: str = "disabled"
    http_put_response_hop_limit: int = 2
    http_tokens: str = "required"


@dataclass
class NodeClass:
    name: str
    ami_family: str = "AL2023"   # AL2 | AL2023 | Bottlerocket | Ubuntu | Windows | Custom
    subnet_selector_terms: List[NodeClassSelectorTerm] = field(default_factory=list)
    security_group_selector_terms: List[NodeClassSelectorTerm] = field(default_factory=list)
    ami_selector_terms: List[NodeClassSelectorTerm] = field(default_factory=list)
    user_data: Optional[str] = None
    role: Optional[str] = None
    instance_profile: Optional[str] = None
    tags: Dict[str, str] = field(default_factory=dict)
    # BDM dicts: {"device_name": str, "root_volume": bool,
    # "volume_size_mib": float} (reference ec2nodeclass.go BlockDeviceMapping)
    block_device_mappings: List[Dict] = field(default_factory=list)
    # None (default: instance-store disks unused) | "RAID0" (local NVMe
    # becomes node ephemeral-storage; reference ec2nodeclass.go:92-94)
    instance_store_policy: Optional[str] = None
    metadata_options: MetadataOptions = field(default_factory=MetadataOptions)
    detailed_monitoring: bool = False
    associate_public_ip: Optional[bool] = None
    annotations: Dict[str, str] = field(default_factory=dict)
    # status (hydrated by the nodeclass controller, reference nodeclass/controller.go:150-233)
    status_subnets: List[Dict] = field(default_factory=list)
    status_security_groups: List[Dict] = field(default_factory=list)
    status_amis: List[Dict] = field(default_factory=list)
    status_instance_profile: Optional[str] = None
    status_conditions: Dict[str, bool] = field(default_factory=dict)


# ---------------------------------------------------------------------------
# NodeClaim lifecycle (core CRD + state machine)
# ---------------------------------------------------------------------------

# the Windows Server 2022 EKS-optimized AMI's build number — the value of
# the well-known node.kubernetes.io/windows-build label every node of a
# windows pool carries (reference labels.go registers v1.LabelWindowsBuild)
WINDOWS_BUILD = "10.0.20348"


def pool_os(pool: "NodePool") -> str:
    """The OS every node of this pool boots (its AMI family's OS,
    surfaced through the pool's os requirement OR its template label —
    scheduling_requirements() folds both). Admission validates the
    requirement to a single-valued In; unvalidated multi-value input
    resolves deterministically (first sorted value). Default: linux."""
    c = pool.scheduling_requirements().get(wellknown.LABEL_OS)
    if c.include:
        return sorted(c.include)[0]
    return "linux"


@dataclass
class Lease:
    """A kube-node-lease Lease (coordination.k8s.io). The kubelet creates
    one per node with an owner reference; orphaned leases (no owner, or an
    owner that no longer exists) are garbage collected by the controller —
    reference test/suites/integration/lease_garbagecollection_test.go."""

    name: str
    owner_node: Optional[str] = None
    created_at: float = field(default_factory=time.time)


class NodeClaimPhase(str, enum.Enum):
    PENDING = "Pending"         # created by scheduler, not yet launched
    LAUNCHED = "Launched"       # cloud capacity created (providerID set)
    REGISTERED = "Registered"   # node joined the cluster
    INITIALIZED = "Initialized" # node ready + startup taints cleared
    TERMINATING = "Terminating"
    TERMINATED = "Terminated"


@dataclass
class NodeClaim:
    name: str
    node_pool: str
    requirements: List[Requirement] = field(default_factory=list)
    resource_requests: Dict[str, float] = field(default_factory=dict)
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    taints: List[Taint] = field(default_factory=list)
    node_class_ref: str = "default"
    # status
    phase: NodeClaimPhase = NodeClaimPhase.PENDING
    # kubelet maxPods from the owning pool's template: CloudProvider.create
    # clamps the pods axis of capacity/allocatable at fill time, so no
    # concurrent solve ever observes the unclamped ENI-derived density
    max_pods: Optional[int] = None
    cluster_dns: Optional[str] = None  # kubelet ClusterDNS from the pool
    provider_id: Optional[str] = None
    internal_ip: Optional[str] = None  # instance private IP (v4 or v6)
    instance_type: Optional[str] = None
    zone: Optional[str] = None
    capacity_type: Optional[str] = None
    image_id: Optional[str] = None
    capacity: Dict[str, float] = field(default_factory=dict)
    allocatable: Dict[str, float] = field(default_factory=dict)
    created_at: float = field(default_factory=time.time)
    launched_at: Optional[float] = None
    registered_at: Optional[float] = None
    initialized_at: Optional[float] = None
    deletion_timestamp: Optional[float] = None

    def scheduling_requirements(self) -> Requirements:
        return Requirements(self.requirements)


@dataclass
class Node:
    name: str
    provider_id: str
    internal_ip: Optional[str] = None  # InternalIP address (v4 or v6)
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    taints: List[Taint] = field(default_factory=list)
    capacity: Dict[str, float] = field(default_factory=dict)
    allocatable: Dict[str, float] = field(default_factory=dict)
    ready: bool = False
    created_at: float = field(default_factory=time.time)
    node_pool: Optional[str] = None
    node_claim: Optional[str] = None
