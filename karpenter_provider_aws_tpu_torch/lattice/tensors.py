"""Catalog → device tensors (the solver's constraint lattice).

The reference builds `[]cloudprovider.InstanceType` — per-type requirement
labels + capacity + overhead + offerings (reference
pkg/providers/instancetype/types.go:56-66,74-155). Here the same information
becomes the dense tensors the device solver consumes:

- ``alloc [T,R]``           allocatable vector per type (capacity - overhead)
- ``capacity [T,R]``        raw capacity
- ``price [T,Z,C]``         offering price (+inf where unavailable)
- ``available [T,Z,C]``     offering availability
- ``cat_ids [K_cat,T]``     categorical label value ids (vocab per key)
- ``num_vals [K_num,T]``    numeric label values (NaN = undefined)

plus host-side mirrors (label dicts per type) for the oracle and for
requirement evaluation outside jit.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from ..apis import wellknown as wk
from ..apis.resources import RESOURCE_AXES, R, axis
from . import catalog as cat
from .overhead import (KubeletConfiguration, allocatable, ebs_attach_limit,
                       max_pods, vm_usable_memory_mib)


def type_labels(spec: cat.InstanceTypeSpec) -> Dict[str, str]:
    """The ~20 requirement labels one instance type carries
    (types.go:74-155 computeRequirements)."""
    labels = {
        wk.LABEL_INSTANCE_TYPE: spec.name,
        wk.LABEL_ARCH: spec.arch,
        wk.LABEL_REGION: cat.REGION,
        wk.LABEL_INSTANCE_CATEGORY: spec.category,
        wk.LABEL_INSTANCE_FAMILY: spec.family,
        wk.LABEL_INSTANCE_GENERATION: str(spec.generation),
        wk.LABEL_INSTANCE_SIZE: spec.size,
        wk.LABEL_INSTANCE_CPU: str(spec.vcpus),
        wk.LABEL_INSTANCE_CPU_MANUFACTURER: spec.cpu_manufacturer,
        wk.LABEL_INSTANCE_MEMORY: str(spec.memory_mib),
        wk.LABEL_INSTANCE_NETWORK_BANDWIDTH: str(spec.network_bandwidth_mbps),
        wk.LABEL_INSTANCE_ENCRYPTION_IN_TRANSIT: "true" if spec.generation >= 5 else "false",
    }
    if spec.hypervisor:
        labels[wk.LABEL_INSTANCE_HYPERVISOR] = spec.hypervisor
    if spec.local_nvme_gb:
        labels[wk.LABEL_INSTANCE_LOCAL_NVME] = str(spec.local_nvme_gb)
    if spec.gpu_count:
        labels[wk.LABEL_INSTANCE_GPU_NAME] = spec.gpu_name
        labels[wk.LABEL_INSTANCE_GPU_MANUFACTURER] = spec.gpu_manufacturer
        labels[wk.LABEL_INSTANCE_GPU_COUNT] = str(spec.gpu_count)
        labels[wk.LABEL_INSTANCE_GPU_MEMORY] = str(spec.gpu_memory_mib)
    if spec.accelerator_count:
        labels[wk.LABEL_INSTANCE_ACCELERATOR_NAME] = spec.accelerator_name
        labels[wk.LABEL_INSTANCE_ACCELERATOR_MANUFACTURER] = spec.accelerator_manufacturer
        labels[wk.LABEL_INSTANCE_ACCELERATOR_COUNT] = str(spec.accelerator_count)
    return labels


DEFAULT_EBS_ROOT_MIB = 20 * 1024.0  # amifamily.DefaultEBS.VolumeSize (20Gi)


@dataclass(frozen=True)
class StorageConfig:
    """NodeClass storage knobs that shape per-type ephemeral capacity
    (reference types.go:210-240 ephemeralStorage). One lattice carries one
    storage config — the reference computes instance types per NodeClass;
    an operator serving NodeClasses with different storage configs builds
    a lattice per config."""

    instance_store_policy: Optional[str] = None   # None | "RAID0"
    block_device_mappings: Tuple[Mapping, ...] = ()
    ephemeral_block_device: Optional[str] = None  # AMI family's root device
    custom_ami_family: bool = False


def ephemeral_storage_mib(spec: cat.InstanceTypeSpec,
                          storage: Optional[StorageConfig] = None) -> float:
    """Node ephemeral-storage capacity, the reference's resolution order
    (types.go:210-240): RAID0 policy takes the combined local NVMe size;
    else a root-volume BDM's size; else (Custom AMI) the last BDM's size;
    else the BDM matching the family's ephemeral device; else 20Gi."""
    s = storage or StorageConfig()
    if s.instance_store_policy == "RAID0" and spec.local_nvme_gb:
        return spec.local_nvme_gb * 1000.0 / 1.048576   # GB -> MiB
    bdms = s.block_device_mappings
    if bdms:
        for b in bdms:
            if b.get("root_volume") and b.get("volume_size_mib"):
                return float(b["volume_size_mib"])
        if s.custom_ami_family:
            last = bdms[-1]
            if last.get("volume_size_mib"):
                return float(last["volume_size_mib"])
        elif s.ephemeral_block_device:
            for b in bdms:
                if (b.get("device_name") == s.ephemeral_block_device
                        and b.get("volume_size_mib")):
                    return float(b["volume_size_mib"])
    return DEFAULT_EBS_ROOT_MIB


def capacity_vec(spec: cat.InstanceTypeSpec, kc: Optional[KubeletConfiguration] = None,
                 vm_memory_overhead_percent: float = 0.075, reserved_enis: int = 0,
                 storage: Optional[StorageConfig] = None) -> Tuple[np.ndarray, int]:
    """Capacity vector + pod density (types.go:176-208 computeCapacity)."""
    vec = np.zeros((R,), dtype=np.float32)
    pods = max_pods(spec.enis, spec.ipv4_per_eni, spec.vcpus, kc, reserved_enis=reserved_enis)
    vec[axis("cpu")] = spec.vcpus * 1000.0
    vec[axis("memory")] = vm_usable_memory_mib(spec.memory_mib, spec.arch, vm_memory_overhead_percent)
    vec[axis("pods")] = pods
    vec[axis("ephemeral-storage")] = ephemeral_storage_mib(spec, storage)
    # GPUs surface as per-manufacturer extended resources (reference
    # types.go:176-192: nvidia.com/gpu, amd.com/gpu, habana.ai/gaudi)
    gm = (spec.gpu_manufacturer or "").lower()
    vec[axis("nvidia.com/gpu")] = spec.gpu_count if gm in ("", "nvidia") else 0
    vec[axis("amd.com/gpu")] = spec.gpu_count if gm == "amd" else 0
    vec[axis("habana.ai/gaudi")] = spec.gpu_count if gm == "habana" else 0
    vec[axis("aws.amazon.com/neuron")] = (
        spec.accelerator_count
        if (spec.accelerator_name or "").lower()
        in ("inferentia", "inferentia2", "trainium") else 0)
    vec[axis("vpc.amazonaws.com/efa")] = spec.efa_count
    vec[axis("vpc.amazonaws.com/pod-eni")] = spec.pod_eni_count
    vec[axis("attachable-volumes")] = ebs_attach_limit(spec.hypervisor, spec.enis)
    return vec, pods


@dataclass
class Lattice:
    """The full constraint lattice, device-ready."""

    specs: List[cat.InstanceTypeSpec]
    names: List[str]
    labels: List[Dict[str, str]]           # host-side label dicts per type
    zones: Tuple[str, ...]
    capacity_types: Tuple[str, ...]
    capacity: np.ndarray                   # [T,R] float32
    alloc: np.ndarray                      # [T,R] float32
    price: np.ndarray                      # [T,Z,C] float32, +inf unavailable
    available: np.ndarray                  # [T,Z,C] bool
    cat_vocab: Dict[str, Dict[str, int]]   # key -> value -> id (id 0 = undefined)
    cat_ids: np.ndarray                    # [K_cat,T] int32
    num_vals: np.ndarray                   # [K_num,T] float32, NaN undefined
    name_to_idx: Dict[str, int] = field(default_factory=dict)
    # bumped whenever price is rewritten in place (pricing refresh) so
    # device-resident copies know to re-upload
    price_version: int = 0
    # the UNMASKED availability this view derives from (None on a base
    # lattice): masked_view records it so the explain engine
    # (solver/explain.py) can attribute eliminations to the ICE /
    # unavailable mask specifically — "was offered, currently held out"
    # vs "never offered at all"
    base_available: Optional[np.ndarray] = field(
        default=None, repr=False, compare=False)
    # key_values_present memo (labels are static per lattice); carried
    # through masked_view's replace() too, which is correct — masked
    # views share the same labels
    _kv_cache: Optional[Dict[str, List[str]]] = field(
        default=None, repr=False, compare=False)

    @property
    def T(self) -> int:
        return len(self.names)

    @property
    def Z(self) -> int:
        return len(self.zones)

    @property
    def C(self) -> int:
        return len(self.capacity_types)

    def key_values_present(self) -> Dict[str, List[str]]:
        """key -> distinct values across the lattice (for minValues
        checks). Labels are static per lattice, so the scan memoizes —
        build_problem calls this on every batch and the T-wide dict walk
        was a measurable slice of the 50k-pod host budget."""
        if self._kv_cache is not None:
            return self._kv_cache
        out: Dict[str, set] = {}
        for lab in self.labels:
            for k, v in lab.items():
                out.setdefault(k, set()).add(v)
        self._kv_cache = {k: sorted(v) for k, v in out.items()}
        return self._kv_cache


def masked_view(lattice: Lattice, offering_mask: np.ndarray) -> Lattice:
    """A shallow lattice copy with offerings masked out (ICE feedback: AND
    the UnavailableOfferings mask into availability before a solve). All
    other tensors are shared; shapes are unchanged so jitted kernels are
    reused."""
    from dataclasses import replace

    available = lattice.available & offering_mask
    price = np.where(available, lattice.price, np.inf).astype(np.float32)
    base = (lattice.base_available if lattice.base_available is not None
            else lattice.available)
    return replace(lattice, available=available, price=price,
                   base_available=base)


# masked_view memoized per BASE lattice on (price_version, ICE seq_num):
# a steady controller pass re-solves against an unchanged price table and
# ICE set, and minting a fresh view object every pass would defeat every
# identity-keyed memo downstream (the solver's narrowing cache,
# solver/problem.py _NARROW_CACHE). TTL-expired ICE entries re-enter the
# offering set at the operator's 10 s cleanup tick, which bumps seq_num
# (cache/unavailable.py cleanup; the reference frees offerings on the
# same cadence, cache.go:39-42) — so the memoized view is never staler
# than the reference's own cache. The memo slot is per (base, ICE cache)
# PAIR — seq numbers are only comparable within one UnavailableOfferings
# instance, and two operators may share one injected base lattice — and
# both objects are held strongly: a dead one's id can never alias a
# live key.
_VIEW_MEMO: Dict[tuple, tuple] = {}  # (id(base), id(ice)) -> (base, ice, key, view)
_VIEW_MEMO_MAX = 4


def masked_view_versioned(lattice: Lattice, unavailable) -> Lattice:
    """``masked_view(lattice, unavailable.mask(lattice))`` with the view
    object REUSED while ``(lattice.price_version, unavailable.seq_num)``
    is unchanged. ``unavailable`` is duck-typed (needs ``.mask(lattice)``
    and ``.seq_num``): cache/unavailable.py's UnavailableOfferings."""
    key = (lattice.price_version, unavailable.seq_num)
    slot = (id(lattice), id(unavailable))
    e = _VIEW_MEMO.get(slot)
    if (e is not None and e[0] is lattice and e[1] is unavailable
            and e[2] == key):
        return e[3]
    view = masked_view(lattice, unavailable.mask(lattice))
    if len(_VIEW_MEMO) >= _VIEW_MEMO_MAX:
        _VIEW_MEMO.clear()
    _VIEW_MEMO[slot] = (lattice, unavailable, key, view)
    return view


def build_lattice(specs: Optional[Sequence[cat.InstanceTypeSpec]] = None,
                  kc: Optional[KubeletConfiguration] = None,
                  zones: Sequence[str] = cat.ZONES,
                  capacity_types: Sequence[str] = cat.CAPACITY_TYPES,
                  vm_memory_overhead_percent: float = 0.075,
                  reserved_enis: int = 0,
                  storage: Optional[StorageConfig] = None) -> Lattice:
    specs = list(specs) if specs is not None else cat.build_catalog()
    T, Z, C = len(specs), len(zones), len(capacity_types)

    capacity = np.zeros((T, R), dtype=np.float32)
    alloc = np.zeros((T, R), dtype=np.float32)
    labels = []
    for i, s in enumerate(specs):
        vec, pods = capacity_vec(s, kc, vm_memory_overhead_percent, reserved_enis,
                                 storage)
        capacity[i] = vec
        alloc[i] = allocatable(vec, s.vcpus * 1000.0, pods,
                               vec[axis("memory")], vec[axis("ephemeral-storage")], kc)
        labels.append(type_labels(s))

    price = np.full((T, Z, C), np.inf, dtype=np.float32)
    available = np.zeros((T, Z, C), dtype=bool)
    for i, s in enumerate(specs):
        for zi, zone in enumerate(zones):
            for ci, ct in enumerate(capacity_types):
                if not cat.offering_available(s, zone, ct):
                    continue
                available[i, zi, ci] = True
                if ct == "on-demand":
                    price[i, zi, ci] = cat.od_price(s, zone)
                else:
                    # prefer the spec's data-carried per-AZ spot price
                    # (real-data catalogs); fall back to the synthetic
                    # discount model
                    sp = s.spot_price_in(zone)
                    price[i, zi, ci] = (sp if sp is not None
                                        else cat.spot_price(s, zone))

    # categorical vocab: id 0 reserved for "undefined on this type"
    cat_keys = wk.DEVICE_CATEGORICAL_KEYS
    cat_vocab: Dict[str, Dict[str, int]] = {k: {} for k in cat_keys}
    cat_ids = np.zeros((len(cat_keys), T), dtype=np.int32)
    for ki, key in enumerate(cat_keys):
        vocab = cat_vocab[key]
        for i, lab in enumerate(labels):
            v = lab.get(key)
            if v is None:
                continue
            if v not in vocab:
                vocab[v] = len(vocab) + 1
            cat_ids[ki, i] = vocab[v]

    num_keys = wk.DEVICE_NUMERIC_KEYS
    num_vals = np.full((len(num_keys), T), np.nan, dtype=np.float32)
    for ki, key in enumerate(num_keys):
        for i, lab in enumerate(labels):
            v = lab.get(key)
            if v is not None:
                num_vals[ki, i] = float(v)

    return Lattice(
        specs=specs, names=[s.name for s in specs], labels=labels,
        zones=tuple(zones), capacity_types=tuple(capacity_types),
        capacity=capacity, alloc=alloc, price=price, available=available,
        cat_vocab=cat_vocab, cat_ids=cat_ids, num_vals=num_vals,
        name_to_idx={s.name: i for i, s in enumerate(specs)},
    )
