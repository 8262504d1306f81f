"""Admission webhooks: defaulting + validation.

Mirror of the reference's knative-style admission controllers (reference
pkg/webhooks/webhooks.go over pkg/apis/v1beta1 CEL rules + core NodePool
validation). Invalid objects are rejected before they enter the control
plane; defaulting fills the canonical optional fields.
"""

from __future__ import annotations

import math
from typing import List

from .apis import wellknown as wk
from .apis.objects import NodeClass, NodePool
from .apis.requirements import Operator, Requirement
from .apis.resources import RESOURCE_AXES, resources_to_vec
from .providers.amifamily import AMI_FAMILIES

# keys users may not constrain (reference restricted label domains)
RESTRICTED_LABEL_DOMAINS = ("kubernetes.io/hostname",)


class AdmissionError(ValueError):
    pass


def default_node_pool(pool: NodePool) -> NodePool:
    """Defaulting admission: canonical capacity-type + arch + os
    requirements when unset (core NodePool defaults)."""
    keys = {r.key for r in pool.requirements}
    if wk.LABEL_CAPACITY_TYPE not in keys:
        pool.requirements.append(Requirement(
            wk.LABEL_CAPACITY_TYPE, Operator.IN, (wk.CAPACITY_TYPE_ON_DEMAND,)))
    if wk.LABEL_ARCH not in keys:
        pool.requirements.append(Requirement(wk.LABEL_ARCH, Operator.IN, ("amd64",)))
    if wk.LABEL_OS not in keys:
        pool.requirements.append(Requirement(wk.LABEL_OS, Operator.IN, ("linux",)))
    return pool


def validate_node_pool(pool: NodePool) -> List[str]:
    """Validation admission; returns error strings (empty = admitted)."""
    errs: List[str] = []
    if not pool.name:
        errs.append("name is required")
    for r in pool.requirements:
        if r.key in RESTRICTED_LABEL_DOMAINS:
            errs.append(f"requirement on restricted key {r.key!r}")
        if r.min_values is not None and r.min_values < 1:
            errs.append(f"minValues must be >= 1 (key {r.key})")
        if r.key == wk.LABEL_OS:
            # a pool's nodes boot ONE OS (the AMI family's): the os
            # requirement must name exactly one of linux|windows
            if (r.operator != Operator.IN or len(r.values) != 1
                    or r.values[0] not in ("linux", "windows")):
                errs.append("the os requirement must be a single-valued In "
                            "over linux|windows (a pool's nodes boot one "
                            f"OS), got {r.operator.value} {r.values}")
    for key in pool.limits:
        if key not in RESOURCE_AXES:
            errs.append(f"unknown limit resource {key!r}")
        else:
            try:
                resources_to_vec({key: pool.limits[key]})
            except Exception as e:
                errs.append(f"bad limit quantity for {key}: {e}")
    d = pool.disruption
    if d.consolidation_policy not in ("WhenUnderutilized", "WhenEmpty"):
        errs.append(f"unknown consolidationPolicy {d.consolidation_policy!r}")
    if d.consolidation_policy == "WhenEmpty" and d.consolidate_after is None:
        errs.append("consolidateAfter is required with WhenEmpty")
    for b in d.budgets:
        spec = str(b.nodes)
        try:
            val = float(spec[:-1]) if spec.endswith("%") else int(spec)
            if val < 0:
                errs.append(f"budget nodes must be >= 0, got {b.nodes!r}")
        except ValueError:
            errs.append(f"bad budget nodes value {b.nodes!r}")
        # CRD karpenter.sh_nodepools.yaml:111-112: 'schedule' must be set
        # with 'duration' (and vice versa); the schedule must parse
        if (b.schedule is None) != (b.duration is None):
            errs.append("budget schedule and duration must be set together")
        if b.duration is not None and b.duration <= 0:
            # a non-positive duration would make the window unsatisfiable
            # and the budget silently never apply
            errs.append("budget duration must be > 0 seconds")
        if b.schedule is not None:
            from .utils.cron import Cron
            try:
                Cron(b.schedule)
            except ValueError as e:
                errs.append(f"bad budget schedule: {e}")
    if pool.weight < 0 or pool.weight > 100:
        errs.append("weight must be in [0, 100]")
    return errs


def validate_node_class(nc: NodeClass) -> List[str]:
    """EC2NodeClass-analog validation (pkg/apis/v1beta1 CEL rules)."""
    errs: List[str] = []
    if not nc.name:
        errs.append("name is required")
    if nc.ami_family not in AMI_FAMILIES:
        errs.append(f"unknown amiFamily {nc.ami_family!r}")
    if nc.ami_family == "Custom" and not nc.ami_selector_terms:
        errs.append("amiSelectorTerms required with the Custom amiFamily")
    if nc.role and nc.instance_profile:
        errs.append("role and instanceProfile are mutually exclusive")
    if not nc.role and not nc.instance_profile:
        errs.append("one of role or instanceProfile is required")
    for t in nc.subnet_selector_terms + nc.security_group_selector_terms + nc.ami_selector_terms:
        if not t.tags and not t.id and not t.name:
            errs.append("selector term needs tags, id, or name")
    mo = nc.metadata_options
    if mo.http_tokens not in ("required", "optional"):
        errs.append(f"httpTokens must be required|optional, got {mo.http_tokens!r}")
    if mo.http_endpoint not in ("enabled", "disabled"):
        errs.append(f"httpEndpoint must be enabled|disabled, got {mo.http_endpoint!r}")
    if nc.instance_store_policy not in (None, "RAID0"):
        errs.append("instanceStorePolicy must be RAID0 when set, got "
                    f"{nc.instance_store_policy!r}")
    roots = 0
    for b in nc.block_device_mappings:
        if not isinstance(b, dict) or not b.get("device_name"):
            errs.append("blockDeviceMapping needs a device_name")
            continue
        if b.get("root_volume"):
            roots += 1
        size = b.get("volume_size_mib")
        if size is not None and (
                isinstance(size, bool)          # bool is an int subclass
                or not isinstance(size, (int, float))
                or not math.isfinite(size) or size <= 0):
            errs.append(f"blockDeviceMapping {b['device_name']!r} "
                        "volume_size_mib must be a positive finite number")
    if roots > 1:
        errs.append("at most one blockDeviceMapping may set root_volume")
    return errs


def validate_pdb(pdb) -> List[str]:
    """policy/v1 PodDisruptionBudget validation: exactly one of
    maxUnavailable / minAvailable, both non-negative."""
    errs: List[str] = []
    if not pdb.name:
        errs.append("name is required")
    has_max = pdb.max_unavailable is not None
    has_min = pdb.min_available is not None
    if has_max == has_min:
        errs.append("exactly one of maxUnavailable / minAvailable is required")
    if has_max and int(pdb.max_unavailable) < 0:
        errs.append("maxUnavailable must be >= 0")
    if has_min and int(pdb.min_available) < 0:
        errs.append("minAvailable must be >= 0")
    return errs


def admit_pdb(pdb):
    errs = validate_pdb(pdb)
    if errs:
        raise AdmissionError(f"PodDisruptionBudget/{pdb.name}: " + "; ".join(errs))
    return pdb


def admit_node_pool(pool: NodePool) -> NodePool:
    pool = default_node_pool(pool)
    errs = validate_node_pool(pool)
    if errs:
        raise AdmissionError(f"NodePool/{pool.name}: " + "; ".join(errs))
    return pool


def admit_node_class(nc: NodeClass) -> NodeClass:
    errs = validate_node_class(nc)
    if errs:
        raise AdmissionError(f"NodeClass/{nc.name}: " + "; ".join(errs))
    return nc


def validate_wire(kind: str, spec) -> List[str]:
    """One validation entry over WIRE dicts: schema first (apis/schema.py,
    the CRD contract), then the semantic webhook for the kind. This is
    what the in-process apiserver admission runs (kube/client.py) and
    what the HTTP /validate endpoint serves (cli.py) — same answer at
    every boundary."""
    from .apis import schema, serde
    KNOWN = ("nodepools", "nodeclasses", "pdbs", "nodeclaims")
    # the NodeClass CRD's real-world plural (deploy/crds,
    # webhooks.yaml registration) — same object, same validation
    if kind == "ec2nodeclasses":
        kind = "nodeclasses"
    if kind not in KNOWN:
        # an "allowed" answer for a kind we cannot validate would be a
        # false green light (the apiserver rejects unknown kinds)
        return [f"unknown kind {kind!r}; validatable kinds: "
                + ", ".join(KNOWN)]
    errs = schema.validate(kind, spec)
    if errs:
        return errs
    try:
        if kind == "nodepools":
            return validate_node_pool(serde.nodepool_from_dict(spec))
        if kind == "nodeclasses":
            return validate_node_class(serde.nodeclass_from_dict(spec))
        if kind == "pdbs":
            return validate_pdb(serde.pdb_from_dict(spec))
    except Exception as e:  # malformed-but-schema-clean input must reject
        return [f"validation failed: {e}"]
    return []   # nodeclaims: schema-only (status is controller-owned)
