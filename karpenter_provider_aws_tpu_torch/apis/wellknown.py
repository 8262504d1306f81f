"""Well-known scheduling label keys.

Mirrors the label surface the reference registers into the core scheduler
(reference pkg/apis/v1beta1/labels.go:27-116): the k8s topology/arch/os
labels, karpenter.sh pool/capacity-type labels, and the karpenter.k8s.aws
instance-description labels that make requirements like
"karpenter.k8s.aws/instance-cpu Gt 16" work.

``NUMERIC_KEYS`` are the keys whose values compare as numbers (Gt/Lt work);
everything else is categorical. The device mask compiler (ops/masks.py) uses
this split: categorical keys become vocab-id membership tests, numeric keys
become interval tests.
"""

# Domain prefixes (ours, but kept API-compatible in spirit with the reference)
KARPENTER_PREFIX = "karpenter.sh"
PROVIDER_PREFIX = "karpenter.k8s.aws"

# Core well-known keys
LABEL_NODEPOOL = f"{KARPENTER_PREFIX}/nodepool"
LABEL_CAPACITY_TYPE = f"{KARPENTER_PREFIX}/capacity-type"   # on-demand | spot
LABEL_ZONE = "topology.kubernetes.io/zone"
LABEL_REGION = "topology.kubernetes.io/region"
LABEL_INSTANCE_TYPE = "node.kubernetes.io/instance-type"
LABEL_ARCH = "kubernetes.io/arch"                            # amd64 | arm64
LABEL_OS = "kubernetes.io/os"                                # linux | windows
LABEL_WINDOWS_BUILD = "node.kubernetes.io/windows-build"     # e.g. 10.0.20348
LABEL_HOSTNAME = "kubernetes.io/hostname"

# Provider instance-description keys (reference labels.go:27-50)
LABEL_INSTANCE_CATEGORY = f"{PROVIDER_PREFIX}/instance-category"          # c, m, r, t, p, g, inf, trn, ...
LABEL_INSTANCE_FAMILY = f"{PROVIDER_PREFIX}/instance-family"              # c5, m6g, ...
LABEL_INSTANCE_GENERATION = f"{PROVIDER_PREFIX}/instance-generation"      # numeric
LABEL_INSTANCE_SIZE = f"{PROVIDER_PREFIX}/instance-size"                  # large, 2xlarge, metal, ...
LABEL_INSTANCE_CPU = f"{PROVIDER_PREFIX}/instance-cpu"                    # numeric (vCPU)
LABEL_INSTANCE_CPU_MANUFACTURER = f"{PROVIDER_PREFIX}/instance-cpu-manufacturer"  # intel|amd|aws
LABEL_INSTANCE_MEMORY = f"{PROVIDER_PREFIX}/instance-memory"              # numeric (MiB)
LABEL_INSTANCE_NETWORK_BANDWIDTH = f"{PROVIDER_PREFIX}/instance-network-bandwidth"  # numeric (Mbps)
LABEL_INSTANCE_HYPERVISOR = f"{PROVIDER_PREFIX}/instance-hypervisor"      # nitro | xen | '' (metal)
LABEL_INSTANCE_ENCRYPTION_IN_TRANSIT = f"{PROVIDER_PREFIX}/instance-encryption-in-transit-supported"
LABEL_INSTANCE_LOCAL_NVME = f"{PROVIDER_PREFIX}/instance-local-nvme"      # numeric (GiB)
LABEL_INSTANCE_GPU_NAME = f"{PROVIDER_PREFIX}/instance-gpu-name"          # t4, a100, v100, ...
LABEL_INSTANCE_GPU_MANUFACTURER = f"{PROVIDER_PREFIX}/instance-gpu-manufacturer"  # nvidia | habana
LABEL_INSTANCE_GPU_COUNT = f"{PROVIDER_PREFIX}/instance-gpu-count"        # numeric
LABEL_INSTANCE_GPU_MEMORY = f"{PROVIDER_PREFIX}/instance-gpu-memory"      # numeric (MiB)
LABEL_INSTANCE_ACCELERATOR_NAME = f"{PROVIDER_PREFIX}/instance-accelerator-name"        # inferentia, ...
LABEL_INSTANCE_ACCELERATOR_MANUFACTURER = f"{PROVIDER_PREFIX}/instance-accelerator-manufacturer"
LABEL_INSTANCE_ACCELERATOR_COUNT = f"{PROVIDER_PREFIX}/instance-accelerator-count"      # numeric

CAPACITY_TYPE_ON_DEMAND = "on-demand"
CAPACITY_TYPE_SPOT = "spot"
CAPACITY_TYPE_RESERVED = "reserved"

# Taint key the disruption controller uses to cordon candidates
# (reference: karpenter.sh/disruption taint, website concepts/disruption.md)
DISRUPTION_TAINT_KEY = f"{KARPENTER_PREFIX}/disruption"
DISRUPTED_TAINT_VALUE = "disrupting"

# Annotation keys for drift hashing (reference pkg/apis/v1beta1/ec2nodeclass.go Hash)
ANNOTATION_NODECLASS_HASH = f"{PROVIDER_PREFIX}/nodeclass-hash"
ANNOTATION_NODECLASS_HASH_VERSION = f"{PROVIDER_PREFIX}/nodeclass-hash-version"
ANNOTATION_NODEPOOL_HASH = f"{KARPENTER_PREFIX}/nodepool-hash"
ANNOTATION_NODEPOOL_HASH_VERSION = f"{KARPENTER_PREFIX}/nodepool-hash-version"
ANNOTATION_INSTANCE_TAGGED = f"{KARPENTER_PREFIX}/instance-tagged"
# pod/node/NodePool opt-out from voluntary disruption (reference
# website concepts/disruption.md:253,282,294)
ANNOTATION_DO_NOT_DISRUPT = f"{KARPENTER_PREFIX}/do-not-disrupt"
# Tracing & solver-provenance annotations (docs/reference/tracing.md).
# The REST apiserver stamps an incoming request's W3C traceparent onto
# created pods so the provisioning pass that later drains them can join
# the SAME trace (tail of the REST→operator causal chain); the
# provisioner stamps each NodeClaim with the traceparent of the pass
# that planned it plus the solve's provenance (path / degradation /
# per-stage ms / pipelined flag), which `kpctl describe nodeclaims`
# renders so an operator sees WHY a claim's solve was slow or degraded.
ANNOTATION_TRACEPARENT = f"{KARPENTER_PREFIX}/traceparent"
ANNOTATION_SOLVER_PATH = f"{KARPENTER_PREFIX}/solver-path"
ANNOTATION_SOLVER_DEGRADED_REASON = f"{KARPENTER_PREFIX}/solver-degraded-reason"
ANNOTATION_SOLVER_PIPELINED = f"{KARPENTER_PREFIX}/solver-pipelined"
ANNOTATION_SOLVER_WAVES = f"{KARPENTER_PREFIX}/solver-waves"
ANNOTATION_SOLVER_STAGE_MS = f"{KARPENTER_PREFIX}/solver-stage-ms"
ANNOTATION_SOLVER_MESH_DEVICES = f"{KARPENTER_PREFIX}/solver-mesh-devices"
TAG_NAME = "Name"
TAG_NODECLAIM = f"{KARPENTER_PREFIX}/nodeclaim"

# Well-known label keys. Requirements.intersects mirrors the reference's
# `Compatible(..., AllowUndefinedWellKnownLabels)` (cloudprovider.go:248):
# an existence-requiring requirement (In/Exists/Gt/Lt) on a key UNDEFINED on
# the other side is incompatible unless the key is well-known (the lattice
# will define well-known keys for every instance type, so undefined merely
# means "not constrained yet").
WELL_KNOWN_KEYS = frozenset({
    LABEL_NODEPOOL, LABEL_CAPACITY_TYPE, LABEL_ZONE, LABEL_REGION,
    LABEL_INSTANCE_TYPE, LABEL_ARCH, LABEL_OS, LABEL_HOSTNAME,
    LABEL_INSTANCE_CATEGORY, LABEL_INSTANCE_FAMILY, LABEL_INSTANCE_GENERATION,
    LABEL_INSTANCE_SIZE, LABEL_INSTANCE_CPU, LABEL_INSTANCE_CPU_MANUFACTURER,
    LABEL_INSTANCE_MEMORY, LABEL_INSTANCE_NETWORK_BANDWIDTH,
    LABEL_INSTANCE_HYPERVISOR, LABEL_INSTANCE_ENCRYPTION_IN_TRANSIT,
    LABEL_INSTANCE_LOCAL_NVME, LABEL_INSTANCE_GPU_NAME,
    LABEL_INSTANCE_GPU_MANUFACTURER, LABEL_INSTANCE_GPU_COUNT,
    LABEL_INSTANCE_GPU_MEMORY, LABEL_INSTANCE_ACCELERATOR_NAME,
    LABEL_INSTANCE_ACCELERATOR_MANUFACTURER, LABEL_INSTANCE_ACCELERATOR_COUNT,
    # registered like the reference's v1.LabelWindowsBuild (labels.go:48):
    # resolved per pool — every windows pool's nodes carry the build
    LABEL_WINDOWS_BUILD,
})

NUMERIC_KEYS = frozenset({
    LABEL_INSTANCE_GENERATION,
    LABEL_INSTANCE_CPU,
    LABEL_INSTANCE_MEMORY,
    LABEL_INSTANCE_NETWORK_BANDWIDTH,
    LABEL_INSTANCE_LOCAL_NVME,
    LABEL_INSTANCE_GPU_COUNT,
    LABEL_INSTANCE_GPU_MEMORY,
    LABEL_INSTANCE_ACCELERATOR_COUNT,
})

# Keys that participate in the device constraint lattice, in a stable order.
# (hostname is handled structurally — each bin IS a hostname; nodepool is a
# dedicated axis; zone and capacity-type are dedicated offering axes.)
DEVICE_CATEGORICAL_KEYS = (
    LABEL_INSTANCE_TYPE,
    LABEL_ARCH,
    LABEL_INSTANCE_CATEGORY,
    LABEL_INSTANCE_FAMILY,
    LABEL_INSTANCE_SIZE,
    LABEL_INSTANCE_CPU_MANUFACTURER,
    LABEL_INSTANCE_HYPERVISOR,
    LABEL_INSTANCE_ENCRYPTION_IN_TRANSIT,
    LABEL_INSTANCE_GPU_NAME,
    LABEL_INSTANCE_GPU_MANUFACTURER,
    LABEL_INSTANCE_ACCELERATOR_NAME,
    LABEL_INSTANCE_ACCELERATOR_MANUFACTURER,
)
DEVICE_NUMERIC_KEYS = (
    LABEL_INSTANCE_GENERATION,
    LABEL_INSTANCE_CPU,
    LABEL_INSTANCE_MEMORY,
    LABEL_INSTANCE_NETWORK_BANDWIDTH,
    LABEL_INSTANCE_LOCAL_NVME,
    LABEL_INSTANCE_GPU_COUNT,
    LABEL_INSTANCE_GPU_MEMORY,
    LABEL_INSTANCE_ACCELERATOR_COUNT,
)
