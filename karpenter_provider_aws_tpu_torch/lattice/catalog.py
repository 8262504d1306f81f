"""Synthetic EC2-like instance-type catalog.

The reference discovers ~700+ instance types from the live
DescribeInstanceTypes API and ships a 587-line generated test fixture
(reference pkg/fake/zz_generated.describe_instance_types.go, regenerated by
hack/code/instancetype_testdata_gen). This module is our codegen analog: a
deterministic, programmatically generated catalog of ~750 types whose
families, sizes, ENI tables, extended resources and price structure mirror
the real EC2 fleet closely enough to exercise every scheduler behavior
(GPU/Neuron/EFA resources, graviton/amd variants, metal, local NVMe, spot
discounts, zonal price jitter).

Offerings follow the reference's zone x capacity-type structure
(pkg/providers/instancetype/instancetype.go:174-215 createOfferings).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

ZONES = ("us-west-2a", "us-west-2b", "us-west-2c", "us-west-2d",
         "us-west-2-lax-1a")
REGION = "us-west-2"
CAPACITY_TYPES = ("on-demand", "spot")

# Local zones (reference test/suites/localzone: zones discovered with
# ZoneType "local-zone" carry a restricted instance-type palette, no spot
# market, and an on-demand price premium)
LOCAL_ZONES = frozenset({"us-west-2-lax-1a"})
ZONE_TYPES: Dict[str, str] = {
    z: ("local-zone" if z in LOCAL_ZONES else "availability-zone")
    for z in ZONES}
_LOCAL_ZONE_FAMILIES = frozenset({"c5", "m5", "r5", "t3", "g4dn"})
_LOCAL_ZONE_OD_PREMIUM = 1.2


@dataclass(frozen=True)
class InstanceTypeSpec:
    """One instance type's hardware description (the DescribeInstanceTypes
    analog consumed by lattice.tensors and the fake cloud)."""

    name: str                      # e.g. m6i.2xlarge
    family: str                    # m6i
    category: str                  # m
    generation: int                # 6
    size: str                      # 2xlarge
    vcpus: int
    memory_mib: int
    arch: str                      # amd64 | arm64
    cpu_manufacturer: str          # intel | amd | aws
    hypervisor: str                # nitro | xen | '' (metal)
    enis: int
    ipv4_per_eni: int
    network_bandwidth_mbps: int
    local_nvme_gb: int = 0
    gpu_name: Optional[str] = None
    gpu_manufacturer: Optional[str] = None
    gpu_count: int = 0
    gpu_memory_mib: int = 0
    accelerator_name: Optional[str] = None
    accelerator_manufacturer: Optional[str] = None
    accelerator_count: int = 0
    efa_count: int = 0
    pod_eni_count: int = 0         # trunking branch interfaces (security groups for pods)
    od_price: float = 0.0          # on-demand $/hr, us-west-2 baseline
    # data-carried per-AZ spot prices ((zone, $/hr) pairs, kept as a
    # tuple so the frozen dataclass stays hashable); None → the build
    # falls back to the synthetic spot_price() model below. Real-data
    # catalogs populate this (lattice/realdata.py), mirroring the
    # reference's per-AZ spot axis (pricing.go:348-391).
    spot_prices: Optional[Tuple[Tuple[str, float], ...]] = None
    # zone→price map derived from spot_prices, built once on first
    # lookup: every bulk consumer (the lattice price-tensor build and
    # the weather market field's base-price capture) scans the full
    # 759-type × zone grid through this accessor, and each lookup paid
    # an O(zones) tuple walk. Excluded from eq/hash so the dataclass
    # identity stays a function of the data-carried fields.
    _spot_map: Optional[Dict[str, float]] = field(
        default=None, repr=False, compare=False)

    def spot_price_in(self, zone: str) -> Optional[float]:
        if self.spot_prices is None:
            return None
        if self._spot_map is None:
            # frozen dataclass: the memo slot is written through
            # object.__setattr__ (same-valued on every race, so unlocked)
            object.__setattr__(self, "_spot_map", dict(self.spot_prices))
        return self._spot_map.get(zone)


# size -> (vcpu multiplier over .large's 2, ENIs, IPv4/ENI) — mirrors the
# real eni-max-pods table shape (m5.large 3x10 -> 29 pods, m5.4xlarge 8x30
# -> 234, 16xlarge+ 15x50 -> 737)
_SIZES: Dict[str, Tuple[int, int, int]] = {
    "medium":   (1, 2, 4),
    "large":    (2, 3, 10),
    "xlarge":   (4, 4, 15),
    "2xlarge":  (8, 4, 15),
    "4xlarge":  (16, 8, 30),
    "8xlarge":  (32, 8, 30),
    "12xlarge": (48, 8, 30),
    "16xlarge": (64, 15, 50),
    "24xlarge": (96, 15, 50),
    "32xlarge": (128, 15, 50),
    "48xlarge": (192, 15, 50),
    "metal":    (96, 15, 50),
}

# category -> (GiB per vCPU, $/vCPU-hr baseline)
_CATEGORIES = {
    "c": (2.0, 0.0425),
    "m": (4.0, 0.0480),
    "r": (8.0, 0.0630),
    "t": (4.0, 0.0416),
    "i": (8.0, 0.0780),
    "d": (8.0, 0.0690),
    "x": (16.0, 0.1670),
    "z": (8.0, 0.0830),
    "hpc": (4.0, 0.0600),
}

_GENERAL_SIZES = ("large", "xlarge", "2xlarge", "4xlarge", "8xlarge", "12xlarge",
                  "16xlarge", "24xlarge", "32xlarge", "metal")
_BURST_SIZES = ("medium", "large", "xlarge", "2xlarge")

# (family, category, generation, arch, cpu_mfr, suffix-traits, sizes)
# 'd' in suffix => local NVMe; 'n' => high network bandwidth; 'g' => graviton
_FAMILY_DEFS: List[Tuple[str, str, int, str, str, Tuple[str, ...]]] = []


def _def_families():
    out = []
    for cat in ("c", "m", "r"):
        for gen in (4, 5, 6, 7):
            variants = {
                4: ("",),
                5: ("", "a", "d", "n", "ad", "dn"),
                6: ("i", "a", "g", "gd", "id", "in", "gn", "idn"),
                7: ("i", "a", "g", "gd", "gn", "i-flex") if cat == "m" else ("i", "a", "g", "gd", "gn"),
            }[gen]
            for v in variants:
                fam = f"{cat}{gen}{v}"
                arch = "arm64" if "g" in v else "amd64"
                mfr = "aws" if "g" in v else ("amd" if "a" in v else "intel")
                out.append((fam, cat, gen, arch, mfr, v, _GENERAL_SIZES))
    for fam, gen, arch, mfr in (("t2", 2, "amd64", "intel"), ("t3", 3, "amd64", "intel"),
                                ("t3a", 3, "amd64", "amd"), ("t4g", 4, "arm64", "aws")):
        out.append((fam, "t", gen, arch, mfr, "", _BURST_SIZES))
    for fam, cat, gen, arch, mfr, v in (
        ("i3", "i", 3, "amd64", "intel", "d"), ("i3en", "i", 3, "amd64", "intel", "dn"),
        ("i4i", "i", 4, "amd64", "intel", "d"), ("i4g", "i", 4, "arm64", "aws", "gd"),
        ("im4gn", "i", 4, "arm64", "aws", "gdn"), ("is4gen", "i", 4, "arm64", "aws", "gd"),
        ("d3", "d", 3, "amd64", "intel", "d"), ("d3en", "d", 3, "amd64", "intel", "dn"),
        ("x1", "x", 1, "amd64", "intel", ""), ("x1e", "x", 1, "amd64", "intel", ""),
        ("x2gd", "x", 2, "arm64", "aws", "gd"), ("x2idn", "x", 2, "amd64", "intel", "dn"),
        ("x2iedn", "x", 2, "amd64", "intel", "dn"), ("z1d", "z", 1, "amd64", "intel", "d"),
    ):
        out.append((fam, cat, gen, arch, mfr, v, ("large", "xlarge", "2xlarge", "4xlarge", "8xlarge", "16xlarge")))
    for fam, cat, gen, arch, mfr, v, sizes in (
        ("hpc6a", "hpc", 6, "amd64", "amd", "a", ("48xlarge",)),
        ("hpc7g", "hpc", 7, "arm64", "aws", "g", ("4xlarge", "8xlarge", "16xlarge")),
        ("hpc6id", "hpc", 6, "amd64", "intel", "id", ("32xlarge",)),
    ):
        out.append((fam, cat, gen, arch, mfr, v, sizes))
    return out


_FAMILY_DEFS = _def_families()

# GPU / accelerator families: (family, gen, sizes->(vcpu, mem_gib, count), gpu info, $/hr/gpu)
_GPU_DEFS = [
    # family, category, gen, gpu_name, gpu_mem_mib, sizes: {size: (vcpus, mem_gib, gpus, efa)}
    ("p3", "p", 3, "v100", 16384, {"2xlarge": (8, 61, 1, 0), "8xlarge": (32, 244, 4, 0), "16xlarge": (64, 488, 8, 0)}, 3.06),
    ("p4d", "p", 4, "a100", 40960, {"24xlarge": (96, 1152, 8, 4)}, 4.10),
    ("p5", "p", 5, "h100", 81920, {"48xlarge": (192, 2048, 8, 32)}, 12.29),
    ("g4dn", "g", 4, "t4", 16384, {"xlarge": (4, 16, 1, 0), "2xlarge": (8, 32, 1, 0), "4xlarge": (16, 64, 1, 0),
                                   "8xlarge": (32, 128, 1, 0), "12xlarge": (48, 192, 4, 0), "16xlarge": (64, 256, 1, 0)}, 0.526),
    ("g5", "g", 5, "a10g", 24576, {"xlarge": (4, 16, 1, 0), "2xlarge": (8, 32, 1, 0), "4xlarge": (16, 64, 1, 0),
                                   "8xlarge": (32, 128, 1, 0), "12xlarge": (48, 192, 4, 0), "24xlarge": (96, 384, 4, 0),
                                   "48xlarge": (192, 768, 8, 0)}, 1.006),
    ("g6", "g", 6, "l4", 24576, {"xlarge": (4, 16, 1, 0), "2xlarge": (8, 32, 1, 0), "4xlarge": (16, 64, 1, 0),
                                 "8xlarge": (32, 128, 1, 0), "12xlarge": (48, 192, 4, 0), "24xlarge": (96, 384, 4, 0)}, 0.805),
]
_ACCEL_DEFS = [
    # family, category, gen, accel name, mfr, sizes: {size: (vcpus, mem_gib, count, efa)}
    ("inf1", "inf", 1, "inferentia", "aws", {"xlarge": (4, 8, 1, 0), "2xlarge": (8, 16, 1, 0),
                                             "6xlarge": (24, 48, 4, 0), "24xlarge": (96, 192, 16, 0)}, 0.228),
    ("inf2", "inf", 2, "inferentia2", "aws", {"xlarge": (4, 16, 1, 0), "8xlarge": (32, 128, 1, 0),
                                              "24xlarge": (96, 384, 6, 0), "48xlarge": (192, 768, 12, 0)}, 0.76),
    ("trn1", "trn", 1, "trainium", "aws", {"2xlarge": (8, 32, 1, 0), "32xlarge": (128, 512, 16, 8)}, 1.34),
]

# sizes whose nitro trunking supports pod ENIs (security-groups-for-pods)
_POD_ENI_BY_SIZE = {"large": 9, "xlarge": 18, "2xlarge": 38, "4xlarge": 54, "8xlarge": 54,
                    "12xlarge": 54, "16xlarge": 107, "24xlarge": 107, "32xlarge": 107, "48xlarge": 107}


def _jitter(name: str, salt: str, lo: float, hi: float) -> float:
    """Deterministic per-key jitter in [lo, hi)."""
    h = int.from_bytes(hashlib.sha256(f"{name}|{salt}".encode()).digest()[:4], "big")
    return lo + (hi - lo) * (h / 2**32)


def _network_bandwidth(vcpus: int, high_network: bool) -> int:
    base = min(max(int(vcpus * 0.4), 1), 100)  # ~0.4 Gbps per vCPU, capped
    return int(base * (4 if high_network else 1) * 1000)  # Mbps


def _general_types() -> List[InstanceTypeSpec]:
    out = []
    for fam, cat, gen, arch, mfr, suffix, sizes in _FAMILY_DEFS:
        gib_per_vcpu, usd_per_vcpu = _CATEGORIES[cat]
        for size in sizes:
            if size == "metal" and ("g" in suffix or gen < 5):
                continue  # graviton/older gens: no metal in our catalog
            if size == "32xlarge" and gen < 6:
                continue  # 32xlarge sizes arrived with gen 6
            mult, enis, ips = _SIZES[size]
            vcpus = mult
            mem_mib = int(vcpus * gib_per_vcpu * 1024)
            # price: per-vCPU base, generation discount, arch/mfr discounts,
            # nvme/network premiums — deterministic jitter keeps types distinct
            price = vcpus * usd_per_vcpu
            price *= {1: 1.20, 2: 1.10, 3: 1.02, 4: 1.05, 5: 1.00, 6: 0.98, 7: 1.03}[gen]
            if arch == "arm64":
                price *= 0.80
            elif mfr == "amd":
                price *= 0.90
            if "d" in suffix:
                price *= 1.14
            if "n" in suffix:
                price *= 1.25
            price *= _jitter(fam, "fam-price", 0.97, 1.03)
            hypervisor = "" if size == "metal" else ("nitro" if gen >= 5 or cat == "t" else "xen")
            out.append(InstanceTypeSpec(
                name=f"{fam}.{size}", family=fam, category=cat, generation=gen,
                size=size, vcpus=vcpus, memory_mib=mem_mib, arch=arch,
                cpu_manufacturer=mfr, hypervisor=hypervisor, enis=enis,
                ipv4_per_eni=ips,
                network_bandwidth_mbps=_network_bandwidth(vcpus, "n" in suffix),
                local_nvme_gb=int(vcpus * 75) if "d" in suffix else 0,
                pod_eni_count=_POD_ENI_BY_SIZE.get(size, 0) if hypervisor == "nitro" else 0,
                od_price=round(price, 4),
            ))
    return out


def _gpu_types() -> List[InstanceTypeSpec]:
    out = []
    for fam, cat, gen, gpu, gpu_mem, sizes, usd_per_gpu in _GPU_DEFS:
        for size, (vcpus, mem_gib, gpus, efa) in sizes.items():
            enis, ips = (15, 50) if vcpus >= 48 else (8, 30) if vcpus >= 16 else (4, 15)
            price = vcpus * 0.045 + gpus * usd_per_gpu
            price *= _jitter(f"{fam}.{size}", "gpu-price", 0.98, 1.02)
            out.append(InstanceTypeSpec(
                name=f"{fam}.{size}", family=fam, category=cat, generation=gen,
                size=size, vcpus=vcpus, memory_mib=mem_gib * 1024, arch="amd64",
                cpu_manufacturer="intel", hypervisor="nitro", enis=enis,
                ipv4_per_eni=ips, network_bandwidth_mbps=_network_bandwidth(vcpus, efa > 0),
                gpu_name=gpu, gpu_manufacturer="nvidia", gpu_count=gpus,
                gpu_memory_mib=gpu_mem, efa_count=efa,
                pod_eni_count=_POD_ENI_BY_SIZE.get(size, 0),
                od_price=round(price, 4),
            ))
    for fam, cat, gen, accel, mfr, sizes, usd_per_accel in _ACCEL_DEFS:
        for size, (vcpus, mem_gib, count, efa) in sizes.items():
            enis, ips = (15, 50) if vcpus >= 48 else (8, 30) if vcpus >= 16 else (4, 15)
            price = vcpus * 0.04 + count * usd_per_accel
            price *= _jitter(f"{fam}.{size}", "accel-price", 0.98, 1.02)
            out.append(InstanceTypeSpec(
                name=f"{fam}.{size}", family=fam, category=cat, generation=gen,
                size=size, vcpus=vcpus, memory_mib=mem_gib * 1024, arch="amd64",
                cpu_manufacturer="intel", hypervisor="nitro", enis=enis,
                ipv4_per_eni=ips, network_bandwidth_mbps=_network_bandwidth(vcpus, efa > 0),
                accelerator_name=accel, accelerator_manufacturer=mfr,
                accelerator_count=count, efa_count=efa,
                pod_eni_count=_POD_ENI_BY_SIZE.get(size, 0),
                od_price=round(price, 4),
            ))
    return out


def build_catalog() -> List[InstanceTypeSpec]:
    """The full deterministic catalog, sorted by name."""
    return sorted(_general_types() + _gpu_types(), key=lambda t: t.name)


def spot_price(spec: InstanceTypeSpec, zone: str) -> float:
    """Synthetic spot market: ~30-45% of on-demand with per-zone jitter
    (the reference fetches this per-AZ from DescribeSpotPriceHistory,
    pricing.go:348-391)."""
    return round(spec.od_price * _jitter(spec.name, f"spot|{zone}", 0.30, 0.45), 4)


def od_zone_multiplier(zone: str) -> float:
    """Zonal scale on the regional on-demand price (local-zone premium).
    Shared by the static lattice build and the pricing provider's live
    overlay so the two can't diverge."""
    return _LOCAL_ZONE_OD_PREMIUM if zone in LOCAL_ZONES else 1.0


def od_price(spec: InstanceTypeSpec, zone: str) -> float:
    """Zonal on-demand price: local zones charge a premium over the
    region's AZs."""
    return round(spec.od_price * od_zone_multiplier(zone), 4)


def offering_available(spec: InstanceTypeSpec, zone: str, capacity_type: str) -> bool:
    """Static availability shape: a few types are missing from some zones
    (like real EC2), metal/old-gen have no spot in zone d, and local
    zones carry a small family palette with no spot market."""
    if zone in LOCAL_ZONES:
        return (spec.family in _LOCAL_ZONE_FAMILIES
                and spec.size != "metal"
                and capacity_type == "on-demand")
    if zone == "us-west-2d" and (spec.size == "metal" or spec.generation <= 3):
        return False
    if spec.category in ("p", "trn") and zone in ("us-west-2c", "us-west-2d"):
        return False  # scarce accelerators live in fewer zones
    if capacity_type == "spot" and spec.size == "metal":
        return False
    return True
