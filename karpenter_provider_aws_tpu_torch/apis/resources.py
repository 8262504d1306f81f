"""Canonical resource axes for the solver's dense resource vectors.

The reference models resources as open string->Quantity maps
(corev1.ResourceList); the device solver needs a fixed dense axis, so we pin
the resource kinds the reference actually schedules on: cpu/memory/pods/
ephemeral-storage plus the AWS extended resources the instance-type provider
registers (reference pkg/providers/instancetype/types.go:176-192 — GPU,
Neuron, EFA, pod-ENI; pkg/apis/v1beta1/labels.go:89-116).

Canonical units (see utils.units): cpu millicores, memory/storage MiB,
everything else plain counts. All vectors are float32 on device.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np

from ..utils.units import parse_cpu_millis, parse_mem_mib, parse_quantity

RESOURCE_AXES = (
    "cpu",                       # millicores
    "memory",                    # MiB
    "pods",                      # count (ENI-limited density lives here)
    "ephemeral-storage",         # MiB
    "nvidia.com/gpu",            # count
    "amd.com/gpu",               # count (reference types.go:176-192 maps
    "habana.ai/gaudi",           #   GPUs per manufacturer: nvidia/amd/habana)
    "aws.amazon.com/neuron",     # count
    "vpc.amazonaws.com/efa",     # count
    "vpc.amazonaws.com/pod-eni", # count
    "attachable-volumes",        # count: CSI volume attach slots (EBS shares
                                 # the instance's attachment slots with ENIs;
                                 # the reference discovers per-node limits
                                 # from CSINode at runtime —
                                 # website/…/troubleshooting.md:277-299)
)
R = len(RESOURCE_AXES)

_AXIS_INDEX: Dict[str, int] = {name: i for i, name in enumerate(RESOURCE_AXES)}

_PARSERS = {
    "cpu": parse_cpu_millis,
    "memory": parse_mem_mib,
    "ephemeral-storage": parse_mem_mib,
}


def resources_to_vec(resources: Mapping[str, "str | int | float"], *, implicit_pod: bool = False) -> np.ndarray:
    """Convert a resource map to the canonical float32 vector.

    Unknown resource names raise (better to fail loudly than silently drop a
    constraint); batch callers that must degrade per-pod instead of aborting
    the whole solve use ``resources_to_vec_checked``. ``implicit_pod=True``
    adds the 1-pod occupancy every real pod consumes (the density constraint
    the reference enforces via maxPods).
    """
    vec, unknown = resources_to_vec_checked(resources, implicit_pod=implicit_pod)
    if unknown:
        raise ValueError(f"unknown resource(s) {unknown}; known axes: {RESOURCE_AXES}")
    return vec


def resources_to_vec_checked(
    resources: Mapping[str, "str | int | float"], *, implicit_pod: bool = False
) -> "tuple[np.ndarray, tuple[str, ...]]":
    """Like resources_to_vec but returns ``(vec, unknown_names)`` so a batch
    solve can mark just the offending pod unschedulable (the reference treats
    an unregistered extended resource as an incompatibility for that pod only,
    never a scheduler abort)."""
    vec = np.zeros((R,), dtype=np.float32)
    unknown = []
    for name, qty in resources.items():
        idx = _AXIS_INDEX.get(name)
        if idx is None:
            unknown.append(name)
            continue
        vec[idx] = _PARSERS.get(name, parse_quantity)(qty)
    if implicit_pod:
        vec[_AXIS_INDEX["pods"]] = max(vec[_AXIS_INDEX["pods"]], 1.0)
    return vec, tuple(unknown)


def vec_to_resources(vec: np.ndarray) -> Dict[str, float]:
    """Inverse of resources_to_vec (values stay in canonical units)."""
    return {name: float(vec[i]) for i, name in enumerate(RESOURCE_AXES) if vec[i] != 0}


def vec_to_quantities(vec: np.ndarray) -> Dict[str, str]:
    """Canonical vector → k8s quantity strings, for status surfaces
    (the reference NodePool's status.resources): cpu in millicores
    ("12000m"), memory/ephemeral-storage in Mi, counts plain. Zero axes
    are omitted, like a resource list."""
    out: Dict[str, str] = {}
    for i, name in enumerate(RESOURCE_AXES):
        v = float(vec[i])
        if v == 0:
            continue
        if name == "cpu":
            out[name] = f"{int(round(v))}m"
        elif name in ("memory", "ephemeral-storage"):
            out[name] = f"{int(round(v))}Mi"
        else:
            out[name] = f"{int(round(v))}"
    return out


def canonical_to_vec(resources: Mapping[str, float],
                     missing: float = 0.0) -> np.ndarray:
    """Canonical-unit map (cpu millicores, memory MiB — e.g. a NodeClaim's
    status.capacity round-tripped through vec_to_resources) → vector.
    No quantity parsing: values are already in axis units. ``missing``
    fills axes the map does not mention — pass NaN when the caller wants
    to distinguish "not reported" from "zero" (a node's status rarely
    reports every axis; e.g. attachable-volumes comes from CSINode, which
    may not have registered yet)."""
    vec = np.full((R,), missing, dtype=np.float32)
    for name, qty in resources.items():
        idx = _AXIS_INDEX.get(name)
        if idx is not None:
            vec[idx] = float(qty)
    return vec


def axis(name: str) -> int:
    return _AXIS_INDEX[name]
