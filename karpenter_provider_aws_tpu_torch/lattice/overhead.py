"""Node capacity → allocatable math.

Reimplements the reference's overhead semantics exactly (reference
pkg/providers/instancetype/types.go:176-208 capacity, :341-431 overhead):

- VM memory overhead: advertised MiB minus ceil(mem * vmMemoryOverheadPercent),
  default 7.5% (reference options.go VM_MEMORY_OVERHEAD_PERCENT=0.075);
  arm64 loses an extra 64 MiB of CMA-reserved memory.
- ENI-limited pod density: usableENIs * (IPv4-per-ENI - 1) + 2, with
  reserved-ENI subtraction (types.go:319-333).
- kube-reserved: memory 11*maxPods + 255 Mi; ephemeral-storage 1 Gi; CPU via
  the stepwise core-percentage table 6%/1%/0.5%/0.25% (types.go:349-385).
- eviction threshold: memory 100 Mi; ephemeral-storage 10% of disk
  (types.go:387-414); kubelet eviction signal overrides (percentage or
  absolute).
- allocatable = capacity - kubeReserved - systemReserved - evictionThreshold,
  floored at zero.

All quantities use the canonical units (cpu millicores, memory/storage MiB).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Mapping, Optional

import numpy as np

from ..apis.resources import RESOURCE_AXES, axis, resources_to_vec

DEFAULT_VM_MEMORY_OVERHEAD_PERCENT = 0.075
DEFAULT_POD_DENSITY_CAP = 110  # non-ENI-limited AMI families default to 110 pods


@dataclass
class KubeletConfiguration:
    """Subset of the kubelet config surface that affects allocatable
    (reference corev1beta1.KubeletConfiguration as consumed by types.go)."""

    max_pods: Optional[int] = None
    pods_per_core: Optional[int] = None
    kube_reserved: Dict[str, "str | int | float"] = field(default_factory=dict)
    system_reserved: Dict[str, "str | int | float"] = field(default_factory=dict)
    eviction_hard: Dict[str, str] = field(default_factory=dict)   # {"memory.available": "5%", ...}
    eviction_soft: Dict[str, str] = field(default_factory=dict)


def vm_usable_memory_mib(advertised_mib: float, arch: str = "amd64",
                         vm_memory_overhead_percent: float = DEFAULT_VM_MEMORY_OVERHEAD_PERCENT) -> float:
    mem = float(advertised_mib)
    if arch == "arm64":
        mem -= 64.0  # graviton CMA reservation (types.go:203-205)
    return mem - math.ceil(mem * vm_memory_overhead_percent)


def eni_limited_pods(enis: int, ipv4_per_eni: int, reserved_enis: int = 0) -> int:
    usable = max(enis - reserved_enis, 0)
    if usable == 0:
        return 0
    return usable * (ipv4_per_eni - 1) + 2


def ebs_attach_limit(hypervisor: str, enis: int) -> int:
    """Schedulable EBS volume attachments per node — the lattice's
    prediction of what the EBS CSI driver will report via CSINode once the
    node registers (the reference discovers it only at runtime and can
    over-schedule before CSINode exists, troubleshooting.md:277-299).
    Nitro — including bare metal ('' in the catalog), which runs the same
    nitro card — shares 28 attachment slots between ENIs, the root
    volume, and data volumes; only Xen allows 40 minus the root."""
    if hypervisor == "xen":
        return 39
    return max(28 - enis - 1, 1)


def max_pods(enis: int, ipv4_per_eni: int, vcpus: int, kc: Optional[KubeletConfiguration] = None,
             eni_limited_density: bool = True, reserved_enis: int = 0) -> int:
    """Pod density (types.go:416-431)."""
    if kc is not None and kc.max_pods is not None:
        count = kc.max_pods
    elif eni_limited_density:
        count = eni_limited_pods(enis, ipv4_per_eni, reserved_enis)
    else:
        count = DEFAULT_POD_DENSITY_CAP
    if kc is not None and kc.pods_per_core:
        count = min(kc.pods_per_core * vcpus, count)
    return count


def _stepwise_cpu_reserved_millis(cpu_millis: float) -> float:
    reserved = 0.0
    for start, end, pct in ((0, 1000, 0.06), (1000, 2000, 0.01),
                            (2000, 4000, 0.005), (4000, 1 << 31, 0.0025)):
        if cpu_millis >= start:
            span = (cpu_millis - start) if cpu_millis < end else (end - start)
            reserved += int(span * pct)
    return reserved


def kube_reserved(cpu_millis: float, pods: int, kc: Optional[KubeletConfiguration] = None) -> np.ndarray:
    """kube-reserved vector (types.go:349-385)."""
    vec = np.zeros((len(RESOURCE_AXES),), dtype=np.float32)
    vec[axis("memory")] = 11.0 * pods + 255.0
    vec[axis("ephemeral-storage")] = 1024.0  # 1Gi default
    vec[axis("cpu")] = _stepwise_cpu_reserved_millis(cpu_millis)
    if kc is not None and kc.kube_reserved:
        # keys present in the override map win outright — including explicit
        # zeros (an operator disabling a reservation must see it disabled)
        override = resources_to_vec(kc.kube_reserved)
        for name in kc.kube_reserved:
            vec[axis(name)] = override[axis(name)]
    return vec


def system_reserved(kc: Optional[KubeletConfiguration] = None) -> np.ndarray:
    if kc is not None and kc.system_reserved:
        return resources_to_vec(kc.system_reserved)
    return np.zeros((len(RESOURCE_AXES),), dtype=np.float32)


def _eviction_signal(capacity: float, signal: str) -> float:
    """Percentage or absolute eviction signal (types.go computeEvictionSignal)."""
    s = signal.strip()
    if s.endswith("%"):
        return capacity * float(s[:-1]) / 100.0
    from ..utils.units import parse_mem_mib
    return parse_mem_mib(s)


def eviction_threshold(memory_mib: float, storage_mib: float,
                       kc: Optional[KubeletConfiguration] = None,
                       eviction_soft_enabled: bool = True) -> np.ndarray:
    """Eviction overhead vector (types.go:387-414): default 100Mi memory +
    10% of disk, overridden by the max across configured eviction signals."""
    vec = np.zeros((len(RESOURCE_AXES),), dtype=np.float32)
    vec[axis("memory")] = 100.0
    vec[axis("ephemeral-storage")] = math.ceil(storage_mib / 100.0 * 10.0)
    if kc is None:
        return vec
    mem_override, fs_override = 0.0, 0.0
    signals = [kc.eviction_hard]
    if eviction_soft_enabled:
        signals.append(kc.eviction_soft)
    for m in signals:
        if not m:
            continue
        if "memory.available" in m:
            mem_override = max(mem_override, _eviction_signal(memory_mib, m["memory.available"]))
        if "nodefs.available" in m:
            fs_override = max(fs_override, _eviction_signal(storage_mib, m["nodefs.available"]))
    if mem_override > 0:
        vec[axis("memory")] = mem_override
    if fs_override > 0:
        vec[axis("ephemeral-storage")] = fs_override
    return vec


def allocatable(capacity: np.ndarray, cpu_millis: float, pods: int,
                memory_mib: float, storage_mib: float,
                kc: Optional[KubeletConfiguration] = None) -> np.ndarray:
    """capacity - kubeReserved - systemReserved - evictionThreshold, >= 0."""
    overhead = (kube_reserved(cpu_millis, pods, kc)
                + system_reserved(kc)
                + eviction_threshold(memory_mib, storage_mib, kc))
    out = capacity.astype(np.float32) - overhead
    # overhead only ever applies to cpu/memory/storage — never to counted
    # extended resources; clamp at zero like the reference's Quantity math
    return np.maximum(out, 0.0)
