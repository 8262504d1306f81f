"""The plain reference's view of the EC2 catalog: allocatable, labels and offerings.

Reads the frozen catalog copy beside this file (``catalog.json``: the
759 types of the reference's generated tables, each with the reference's
own ``refAllocatable`` figures) and works out, in exact integers and with
plain NumPy, what a node of each type can hold, which requirement labels it
carries, and which (zone, capacity type) offerings it has at what price.

Offerings follow the catalog model the deployments are written against:
five zones, the last a local zone with a small on-demand-only family
palette at a 20 % premium; zone ``d`` without metal or generation 3 and
older; ``p`` and ``trn`` types only in zones ``a`` and ``b``; no spot for
metal. An on-demand price is the regional price rounded to 4 places, a spot
price the catalog's per-zone figure where it has one, else the model's
deterministic discount (30-45 % of on-demand, keyed by a hash of the type
and zone). Prices are float32, as a node's price is reported.

Imports nothing but the standard library and NumPy.
"""

from __future__ import annotations

import hashlib
import json
import pathlib
import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

CATALOG_PATH = pathlib.Path(__file__).with_name("catalog.json")

# the resources the deployments request, in this order
AXES = ("cpu", "memory", "pods", "nvidia.com/gpu", "aws.amazon.com/neuron")
CAPACITY_TYPES = ("on-demand", "spot")

LABEL_CATEGORY = "karpenter.k8s.aws/instance-category"
LABEL_CAPACITY_TYPE = "karpenter.sh/capacity-type"
LABEL_ARCH = "kubernetes.io/arch"
LABEL_GPU_COUNT = "karpenter.k8s.aws/instance-gpu-count"

_FAMILY = re.compile(r"^([a-z]+?)(\d+)([a-z0-9-]*)$")
_LOCAL_FAMILIES = frozenset({"c5", "m5", "r5", "t3", "g4dn"})
_LOCAL_PREMIUM = 1.2


def _jitter(name: str, salt: str, lo: float, hi: float) -> float:
    h = int.from_bytes(hashlib.sha256(f"{name}|{salt}".encode()).digest()[:4], "big")
    return lo + (hi - lo) * (h / 2**32)


@dataclass
class Catalog:
    names: List[str]
    index: Dict[str, int]
    zones: tuple
    labels: List[Dict[str, str]]   # requirement labels per type
    alloc: np.ndarray              # [T,5] int64 allocatable after overhead
    capacity: np.ndarray           # [T,5] int64 raw capacity (no overhead)
    available: np.ndarray          # [T,Z,C] bool
    price: np.ndarray              # [T,Z,C] float32, +inf where unavailable

    @property
    def T(self) -> int:
        return len(self.names)


def _available(family: str, category: str, generation: int, size: str,
               zone: str, local: bool, ct: str) -> bool:
    if local:
        return family in _LOCAL_FAMILIES and size != "metal" and ct == "on-demand"
    if zone.endswith("d") and (size == "metal" or generation <= 3):
        return False
    if category in ("p", "trn") and (zone.endswith("c") or zone.endswith("d")):
        return False
    return not (ct == "spot" and size == "metal")


def load(zones: Sequence[str], local_zones: Sequence[str],
         path: Optional[pathlib.Path] = None) -> Catalog:
    """The priced types of the catalog, sorted by name, over ``zones``."""
    doc = json.loads(pathlib.Path(path or CATALOG_PATH).read_text())
    types = sorted((t for t in doc["types"] if float(t.get("odPrice") or 0) > 0),
                   key=lambda t: t["name"])
    T, Z, C = len(types), len(zones), len(CAPACITY_TYPES)
    alloc = np.zeros((T, len(AXES)), np.int64)
    capacity = np.zeros((T, len(AXES)), np.int64)
    available = np.zeros((T, Z, C), bool)
    price = np.full((T, Z, C), np.inf, np.float32)
    labels = []
    for i, t in enumerate(types):
        family, _, size = t["name"].partition(".")
        m = _FAMILY.match(family)
        category, generation = (m.group(1), int(m.group(2))) if m else (family, 0)
        ra = t["refAllocatable"]
        nvidia = (t.get("gpuManufacturer") or "").lower() in ("", "nvidia")
        alloc[i] = (ra["cpuMilli"], ra["memoryMi"], ra["pods"],
                    ra["gpus"] if nvidia else 0, ra["neurons"])
        capacity[i] = (int(t["vcpus"]) * 1000, int(t["memoryMiB"]), ra["pods"],
                       alloc[i, 3], alloc[i, 4])
        labels.append({LABEL_CATEGORY: category, LABEL_ARCH: t["arch"],
                       LABEL_GPU_COUNT: str(int(t.get("gpuCount") or 0))})
        od = float(t["odPrice"])
        spot = t.get("spotPrices") or {}
        for zi, zone in enumerate(zones):
            local = zone in local_zones
            for ci, ct in enumerate(CAPACITY_TYPES):
                if not _available(family, category, generation, size or "large",
                                  zone, local, ct):
                    continue
                available[i, zi, ci] = True
                if ct == "on-demand":
                    p = round(od * (_LOCAL_PREMIUM if local else 1.0), 4)
                else:
                    p = (float(spot[zone]) if zone in spot
                         else round(od * _jitter(t["name"], f"spot|{zone}", 0.30, 0.45), 4))
                price[i, zi, ci] = p
    names = [t["name"] for t in types]
    return Catalog(names=names, index={n: i for i, n in enumerate(names)},
                   zones=tuple(zones), labels=labels, alloc=alloc,
                   capacity=capacity, available=available, price=price)


def requirement_mask(cat: Catalog, requirements) -> np.ndarray:
    """[T] bool: types whose labels meet every ``(key, op, values)``
    requirement, for the label keys of the catalog (``In``, ``Gt``)."""
    ok = np.ones(cat.T, bool)
    for key, op, values in requirements:
        if key == LABEL_CAPACITY_TYPE:
            continue            # an offering property, not a type label
        got = [lab.get(key) for lab in cat.labels]
        if op == "In":
            ok &= np.array([g in values for g in got])
        elif op == "Gt":
            ok &= np.array([g is not None and int(g) > int(values[0]) for g in got])
        else:
            raise ValueError(f"unsupported operator {op}")
    return ok


def capacity_type_mask(requirements) -> np.ndarray:
    """[C] bool: capacity types a requirement list allows."""
    ok = np.ones(len(CAPACITY_TYPES), bool)
    for key, op, values in requirements:
        if key == LABEL_CAPACITY_TYPE:
            if op != "In":
                raise ValueError(f"unsupported operator {op}")
            ok &= np.array([c in values for c in CAPACITY_TYPES])
    return ok
