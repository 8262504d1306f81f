from .catalog import InstanceTypeSpec, build_catalog, ZONES, CAPACITY_TYPES
from .overhead import (
    eni_limited_pods,
    kube_reserved,
    eviction_threshold,
    allocatable,
    KubeletConfiguration,
)
from .tensors import Lattice, build_lattice

__all__ = [
    "InstanceTypeSpec", "build_catalog", "ZONES", "CAPACITY_TYPES",
    "eni_limited_pods", "kube_reserved", "eviction_threshold", "allocatable",
    "KubeletConfiguration", "Lattice", "build_lattice",
]
