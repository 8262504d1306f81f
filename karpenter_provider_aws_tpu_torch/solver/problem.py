"""Pending pods + NodePools + lattice → the batched constraint problem.

This is the tensorization step the reference performs implicitly, one pod at
a time, inside its Go scheduler loop (core provisioner; see SURVEY.md §2.2).
Here:

1. Pods are **deduplicated into groups** by scheduling signature (requests +
   labels + constraints + tolerations + affinity + spread). 50k pods from a
   handful of deployments collapse to a handful of groups — the key
   observation that makes the packing scan short on device.
2. Each group's requirements compile to boolean masks over the lattice axes
   (ops/masks.py) and to a per-NodePool compatibility row (host-side exact
   algebra, incl. taints/tolerations, custom template labels, minValues).
3. Topology constraints resolve per solver/topology.py: zone/capacity-type
   scoped ones split groups into per-domain subgroups host-side; hostname
   scoped ones compile to per-row caps + affinity-class matrices the kernel
   enforces with per-bin presence masks.
4. NodePools compile to their own masks, daemonset overhead vectors, and a
   weight-descending order (the order the reference tries pools,
   nodepools.md:161-163).
5. Existing capacity (in-flight NodeClaims / registered nodes) becomes
   pre-initialized bins so the solver fills real headroom before opening new
   nodes — the reference simulates against in-flight nodes the same way.

Everything is plain numpy here; solve.py pads and ships to device.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from ..apis import wellknown as wk
from ..apis.objects import (IN_TREE_PROVISIONERS, WINDOWS_BUILD, NodePool,
                            Pod, pool_os, tolerates_all)
from ..apis.requirements import Operator, Requirement, Requirements
from ..apis.resources import R, axis as res_axis, resources_to_vec_checked
from ..lattice.tensors import Lattice
from ..ops.masks import _AXIS_KEYS, _CAT_KEY_INDEX, _NUM_KEY_INDEX, compile_masks
from . import taxonomy
from .topology import _BIG, BoundPod, ClassRegistry, resolve_group_topology


@dataclass
class ExistingBin:
    """A node (or in-flight NodeClaim) offered to the packer as existing
    headroom. ``fixed`` bins keep their instance type; they are never
    re-priced at finalization."""

    name: str
    node_pool: str
    instance_type: str
    zone: str
    capacity_type: str
    used: np.ndarray                      # [R] resources already committed
    alloc_override: Optional[np.ndarray] = None  # [R] if real node alloc differs from lattice
    labels: Dict[str, str] = field(default_factory=dict)  # node labels (custom-key matching)


@dataclass
class PodGroup:
    signature: str
    pod_names: List[str]
    req: np.ndarray                # [R]
    type_mask: np.ndarray          # [T]
    zone_mask: np.ndarray          # [Z]
    cap_mask: np.ndarray           # [C]
    np_ok: np.ndarray              # [NP] bool
    requirements: Requirements     # merged pod-level requirements (for claims)
    max_per_bin: int = _BIG        # hostname spread / self-anti-affinity cap
    spread_class: int = -1         # class whose per-bin count the cap tracks
    single_bin: bool = False       # hostname self-affinity: all replicas co-locate
    match: np.ndarray = None       # [A] selector classes matching this group's labels
    owner: np.ndarray = None       # [A] hostname anti-affinity terms owned
    need: np.ndarray = None        # [A] hostname affinity presence requirements
    strict_custom: bool = False    # has existence-requiring custom-key constraints
                                   # (resolvable only via a known pool's labels)
    unnarrowed_type_mask: Optional[np.ndarray] = None  # pre-accel-narrowing
                                   # mask; the feasibility gate falls back to
                                   # it if narrowing made the group infeasible
    ledger: Optional[object] = None  # solver/explain.py GroupLedger — the
                                   # group's constraint-elimination record
                                   # (None when the build ran explain=False)


@dataclass
class Problem:
    lattice: Lattice
    node_pools: List[NodePool]     # weight-descending order
    groups: List[PodGroup]         # FFD order (sorted descending)
    existing: List[ExistingBin]
    unschedulable: Dict[str, str]  # pod name -> reason
    # dense group arrays, FFD-sorted (host numpy; solve.py pads to buckets)
    req: np.ndarray                # [G,R] f32
    count: np.ndarray              # [G] i32
    g_type: np.ndarray             # [G,T] bool
    g_zone: np.ndarray             # [G,Z] bool
    g_cap: np.ndarray              # [G,C] bool
    g_np: np.ndarray               # [G,NP] bool
    max_per_bin: np.ndarray        # [G] i32
    g_spread: np.ndarray           # [G] i32 spread class (-1 = none)
    single_bin: np.ndarray         # [G] bool
    g_match: np.ndarray            # [G,A] bool
    g_owner: np.ndarray            # [G,A] bool
    g_need: np.ndarray             # [G,A] bool
    strict_custom: np.ndarray      # [G] bool
    # nodepool arrays
    np_type: np.ndarray            # [NP,T] bool
    np_zone: np.ndarray            # [NP,Z] bool
    np_cap: np.ndarray             # [NP,C] bool
    ds_overhead: np.ndarray        # [NP,R] f32 daemonset overhead per new node
    np_alloc_cap: np.ndarray       # [NP,R] f32 allocatable ceiling (+inf;
                                   # kubelet maxPods caps the pods axis)
    # existing-bin arrays
    e_used: np.ndarray             # [E,R] f32
    e_alloc: np.ndarray            # [E,R] f32 (fixed node allocatable)
    e_type: np.ndarray             # [E] i32 type index
    e_zone: np.ndarray             # [E] i32
    e_cap: np.ndarray              # [E] i32
    e_np: np.ndarray               # [E] i32 nodepool index (-1 unknown)
    e_pm: np.ndarray               # [E,A] i32 count of bound pods matching class a
    e_po: np.ndarray               # [E,A] bool bin holds a bound pod owning anti-term a
    warnings: List[str] = field(default_factory=list)  # unsupported-constraint notices
    # groups eliminated entirely at build (no feasible offering, no
    # existing capacity): kept so the explain surface can render their
    # elimination waterfall for the pods now in ``unschedulable``
    dropped_groups: List[PodGroup] = field(default_factory=list)

    @property
    def G(self) -> int:
        return len(self.groups)

    @property
    def NP(self) -> int:
        return len(self.node_pools)

    @property
    def E(self) -> int:
        return len(self.existing)

    @property
    def A(self) -> int:
        return self.g_match.shape[1] if self.g_match.ndim == 2 else 0


_ACCEL_AXES = tuple(
    res_axis(a) for a in ("nvidia.com/gpu", "amd.com/gpu",
                          "habana.ai/gaudi", "aws.amazon.com/neuron"))


# accel types within this per-unit-price factor of the best stay in the
# narrowed set — a little launch flexibility is worth a few % of cost
_ACCEL_UNIT_PRICE_SLACK = 1.05


def _accel_bin_cap(vec: np.ndarray, type_mask: np.ndarray,
                   zone_mask: np.ndarray, cap_mask: np.ndarray,
                   pool_tmask: np.ndarray, existing_tmask: np.ndarray,
                   lattice: Lattice) -> Optional[np.ndarray]:
    """Accelerator bin-splitting: a narrowed type mask that lands
    finalization on the cheapest PER-ACCELERATOR-UNIT types.

    Sequential FFD (the reference's scheduler, and our scan) packs a
    whole accelerator wave into the first bin with room, so one big
    accelerator node hosts it even when small accelerator types cost
    less per unit (measured: 4 one-GPU pods → one g5.12xlarge at
    $1.92/hr where four g5.xlarge cost $1.54); generic pods riding that
    bin then UPSIZE it further at finalization. Two counter-moves, both
    computed from the live (ICE-masked) lattice:

    - narrow the group's type mask to types within
      ``_ACCEL_UNIT_PRICE_SLACK`` of the best per-unit price (keeping
      only types that fit at least one pod). NEW bins then hold only as
      many accelerator pods as the small types' own capacity — the wave
      splits via ordinary capacity math, with no per-bin cap that would
      also throttle joins onto EXISTING accelerator nodes — and a
      joining generic pod can consume a bin's true leftover but never
      upsize it.

    Splitting is never worse on accelerator cost — k small nodes at the
    best unit price cost ≤ one big node holding k units, by definition
    of the per-unit argmin — and displaced generic pods land on far
    cheaper general capacity. The FFD referee (which packs the SAME
    capped problem) keeps parity honest; tests/test_solver.py pins the
    absolute win against the UNCAPPED pack.

    Correctness fences (review r4): candidates intersect the group's
    POOL-feasible types (``pool_tmask`` — a p3-only pool ranks within p3,
    never narrowing itself unschedulable), prices reduce over the group's
    OWN zone/capacity-type masks (an on-demand-only pool ranks by
    on-demand prices, not spot), and accelerator-capable EXISTING node
    types stay in the mask (free GPUs on a running multi-GPU node always
    beat a launch).

    Returns the narrowed mask, or None when no accelerator demand or
    nothing to gain."""
    for ax in _ACCEL_AXES:
        per_pod = float(vec[ax])
        if per_pod <= 0:
            continue
        if not zone_mask.any() or not cap_mask.any():
            return None
        counts = lattice.capacity[:, ax]
        # a candidate must hold at least one WHOLE pod (all axes) AND be
        # launchable by some compatible pool
        fits_one = (lattice.alloc >= vec[None, :]).all(axis=1)
        feasible = type_mask & (counts >= per_pod) & fits_one
        cand = feasible & pool_tmask
        if not cand.any():
            return None
        idx = np.nonzero(cand)[0]
        # cheapest offering per candidate, WITHIN the group's own zone and
        # capacity-type masks (only candidate rows: the reduction stays
        # O(|cand|·Z·C), not O(T·Z·C) per group)
        offers = lattice.available[np.ix_(idx, np.nonzero(zone_mask)[0],
                                          np.nonzero(cap_mask)[0])]
        prices = np.where(
            offers,
            lattice.price[np.ix_(idx, np.nonzero(zone_mask)[0],
                                 np.nonzero(cap_mask)[0])],
            np.inf)
        pmin = prices.reshape(len(idx), -1).min(axis=1)
        per_unit = pmin / np.maximum(counts[idx], 1e-9)
        b = int(np.argmin(per_unit))
        if not np.isfinite(per_unit[b]):
            return None
        keep = np.zeros(type_mask.shape, dtype=bool)
        keep[idx[per_unit <= per_unit[b] * _ACCEL_UNIT_PRICE_SLACK]] = True
        # existing accelerator-capable node types stay joinable — their
        # free capacity is already paid for
        keep |= feasible & existing_tmask
        return keep
    return None


# a group only counts as a "wave" (per-pod-cost narrowing candidate)
# above this many identical pods; below it, bin-sharing with other
# groups usually matters more than homogeneous type choice
_WAVE_MIN_PODS = 64
# trigger only when the predicted per-pod saving is large (best per-pod
# cost ≤ this fraction of the densest type's per-pod cost): flat price
# curves — the common case, where FFD is already near-optimal — must
# not be fragmented for marginal gains
_WAVE_GAIN = 0.7
_WAVE_PRICE_SLACK = 1.05
# density floor: the whole BATCH may narrow into at most this many
# bins' worth of nodes — each wave's candidates must hold at least
# total_pending/this pods per bin. Nodes are not free beyond their
# price (kubelet, daemonsets, API-object load, and the pack kernel's
# scan length all scale with bin count), so the narrowing picks the
# best per-pod cost among types that keep the plan size bounded rather
# than fragmenting a 50k-pod batch into thousands of burstable
# nanonodes. The floor is GLOBAL (total pending / bins), not
# per-group: a batch of thirty 1.6k-pod waves fragments exactly like
# one 50k wave, and a per-group bound cannot see that.
_WAVE_MAX_BINS = 1024

# narrowing results memoized by CONTENT (every array input's bytes)
# plus lattice identity: the numpy reductions in
# _accel_bin_cap/_wave_candidates are ~0.5 ms per group, and a steady
# controller rebuilds the same groups every batch. The cached value is
# COUNT-INDEPENDENT — the accel mask plus the wave candidate table
# (idx, per-bin fit K, cheapest price pmin); the cheap floor/gain
# decision that DOES depend on the group's count and the batch's total
# pending (_wave_mask_from_table) re-runs on every call. This is what
# lets a steady-state reconcile whose pod counts drift a little reuse
# the expensive reductions for every untouched group (the incremental
# build path, solver/incremental.py) while staying bit-identical to a
# from-scratch rebuild. price/availability moves invalidate via
# price_version in the key and the `is` check on the stored lattice ref
# (pricing mutates price[...] in place but bumps the version; ICE
# produces a NEW masked_view lattice object — holding the ref strongly
# means a dead lattice's id can never alias a live key). Two-level: at
# most _NARROW_LATS lattices are retained (an ICE-churning controller
# mints a masked_view per cycle; an unbounded flat map would pin every
# dead one), each with at most _NARROW_MAX per-group entries. Guarded
# by build_problem's _INTERN_LOCK.
_NARROW_MAX = 4096
_NARROW_LATS = 4
_NARROW_CACHE: Dict[int, tuple] = {}   # id(lat) -> (lattice, {key: entry})
_WAVE_UNSET = object()   # wave candidate table not computed yet (lazy)


def _wave_bin_cap(vec: np.ndarray, count: int, type_mask: np.ndarray,
                  zone_mask: np.ndarray, cap_mask: np.ndarray,
                  pool_tmask: np.ndarray, existing_tmask: np.ndarray,
                  ds_vec: np.ndarray, lattice: Lattice,
                  max_per_bin: int = 0,
                  total_pending: int = 0) -> Optional[np.ndarray]:
    """Per-POD-cost narrowing for pods-axis-bound waves.

    Sequential FFD (the reference's scheduler: first-fit, then price each
    bin at its cheapest fitting type — designs/bin-packing.md:16-43)
    grows a tiny-pod wave's bins to the maximum pod DENSITY any feasible
    type offers, then must price at the huge types that carry that
    density (ENI-limited pods: 737 needs 15×50-ENI machines). When the
    wave is bound by the pods axis rather than cpu/memory, the big
    type's vCPUs go unused and its $/pod is several times worse than a
    small type's (real catalog: m5.24xlarge at 737 pods = $6.3e-3/pod vs
    t3.medium-class nodes under $2.5e-3/pod). This narrows the wave's
    type mask to the types within ``_WAVE_PRICE_SLACK`` of the best
    per-pod cost, so bins seal at the small types' own density and the
    wave splits via ordinary capacity math.

    Per-pod cost of a type = its cheapest offering price (within the
    group's OWN zone/captype masks) divided by how many of THIS group's
    pods fit an empty bin of that type after daemonset overhead — the
    pods axis, cpu, memory, and every other requested axis all cap the
    fit, so the ranking is exact for homogeneous bins.

    Fences mirror _accel_bin_cap: candidates intersect the group's
    pool-feasible types; existing node types stay joinable (their free
    capacity is paid for); the caller holds the unnarrowed mask as a
    schedulability fallback; and the ``_WAVE_GAIN`` gate keeps the
    narrowing OFF whenever FFD's densest-type choice is already within
    30% of optimal — only genuinely pods-axis-bound shapes trigger.
    Never applied to accelerator groups (_accel_bin_cap owns those).
    """
    table = _wave_candidates(vec, type_mask, zone_mask, cap_mask,
                             pool_tmask, ds_vec, lattice)
    if table is None:
        return None
    return _wave_mask_from_table(table, count, type_mask, existing_tmask,
                                 max_per_bin, total_pending)


def _wave_candidates(vec: np.ndarray, type_mask: np.ndarray,
                     zone_mask: np.ndarray, cap_mask: np.ndarray,
                     pool_tmask: np.ndarray, ds_vec: np.ndarray,
                     lattice: Lattice) -> Optional[tuple]:
    """The COUNT-INDEPENDENT half of the wave narrowing: the expensive
    per-candidate reductions — how many of this group's pods fit an empty
    bin of each candidate type (K, pre-spread-clamp) and the cheapest
    offering price within the group's own zone/captype masks (pmin).
    Everything here depends only on the group's content and the lattice,
    so the narrowing cache can reuse it across passes whose pod counts
    drifted; _wave_mask_from_table applies the count/total-dependent
    floor and gain gates per call."""
    if not zone_mask.any() or not cap_mask.any():
        return None
    cand = type_mask & pool_tmask
    if not cand.any():
        return None
    idx = np.nonzero(cand)[0]
    # pods of this group per empty bin of each candidate type
    free = lattice.alloc[idx] - ds_vec[None, :]
    need = vec[None, :]
    with np.errstate(divide="ignore", invalid="ignore"):
        per_axis = np.where(need > 0, free / np.maximum(need, 1e-9), np.inf)
    K = np.floor(per_axis.min(axis=1))
    # the K >= 1 feasibility filter commutes with the spread clamp
    # (min(K, mpb) >= 1 ⇔ K >= 1 whenever mpb >= 1, and mpb == 0 means
    # no clamp), so filtering pre-clamp keeps the table count-free
    fits = K >= 1
    if not fits.any():
        return None
    idx, K = idx[fits], K[fits]
    # price every candidate BEFORE the floor: the floor's relaxation
    # point must be the densest candidate that actually has an offering
    # in the group's zone/captype masks — an ICE'd or out-of-zone big
    # type must not anchor a floor no available type can meet
    offers = lattice.available[np.ix_(idx, np.nonzero(zone_mask)[0],
                                      np.nonzero(cap_mask)[0])]
    prices = np.where(
        offers,
        lattice.price[np.ix_(idx, np.nonzero(zone_mask)[0],
                             np.nonzero(cap_mask)[0])],
        np.inf)
    pmin = prices.reshape(len(idx), -1).min(axis=1)
    if not np.isfinite(pmin).any():
        return None
    return idx, K, pmin


def _wave_mask_from_table(table: tuple, count: int, type_mask: np.ndarray,
                          existing_tmask: np.ndarray, max_per_bin: int,
                          total_pending: int) -> Optional[np.ndarray]:
    """The cheap per-call half of the wave narrowing: the density floor
    and the gain gate over an already-computed candidate table. O(|cand|)
    numpy over a handful of candidates — safe to re-run on every build."""
    if count < _WAVE_MIN_PODS:
        return None
    idx, K, pmin = table
    if max_per_bin:
        # hostname-spread groups seal bins early; rank at the density
        # the bins will actually reach
        K = np.minimum(K, max_per_bin)
    priced = np.isfinite(pmin)
    # density floor (see _WAVE_MAX_BINS): candidates must carry the
    # batch-wide density that keeps the whole plan bounded — relaxed to
    # the densest PRICED candidate when nothing meets it (a t-family-only
    # pool offers only small types; FFD would use them too, and the gain
    # gate still decides). A hostname-spread wave needs no extra clamp:
    # K was already capped to max_per_bin above, so the densest-candidate
    # relaxation can never demand more than the spread's per-bin cap.
    floor = max(total_pending, count) / _WAVE_MAX_BINS
    floor = min(floor, float(K[priced].max()))
    meets_floor = (K >= floor) & priced
    idx, K, pmin = idx[meets_floor], K[meets_floor], pmin[meets_floor]
    per_pod = pmin / K
    b = int(np.argmin(per_pod))
    # what FFD would effectively pay: the per-pod cost of the DENSEST
    # priced type (first-fit grows bins to max density; end-pricing then
    # needs a type carrying that density)
    dense = int(np.argmax(K))
    ffd_per_pod = per_pod[dense]
    if per_pod[b] > ffd_per_pod * _WAVE_GAIN:
        return None
    keep = np.zeros(type_mask.shape, dtype=bool)
    keep[idx[per_pod <= per_pod[b] * _WAVE_PRICE_SLACK]] = True
    # existing node types stay joinable — free capacity is paid for
    keep |= type_mask & existing_tmask
    return keep


def _is_custom_key(key: str) -> bool:
    """A label key the lattice does not model (user-defined)."""
    return (key not in _AXIS_KEYS and key not in _CAT_KEY_INDEX
            and key not in _NUM_KEY_INDEX and key != wk.LABEL_REGION)


def _resolve_custom_sigma(reqs, pool: NodePool, preqs,
                          gen: str) -> Optional[Dict[str, str]]:
    """Custom-key labels a node of ``pool`` must carry to host this group,
    for keys the pool leaves FREE via a template requirement (Exists, or
    In over several values — reference scheduling.md:536-556). Returns
    None when no labeling can satisfy the group on this pool, {} when
    nothing needs pinning (template labels or absence already resolve
    every key), else the value assignment. ``gen`` is the generated value
    used when the group demands existence without naming one."""
    offered = set(preqs.keys())
    sigma: Dict[str, str] = {}
    for key in reqs.keys():
        if not _is_custom_key(key):
            continue
        c = reqs.get(key)
        if key in pool.labels:
            if not c.matches(pool.labels[key]):
                return None
            continue
        if key not in offered:
            if not c.allows_absent:
                return None
            continue
        if c.allows_absent and c.include is None:
            # e.g. NotIn: satisfied without the key; no pin needed
            continue
        both = c.intersect(preqs.get(key))
        if both.include is not None:
            picks = sorted(v for v in both.include if both.matches(v))
            if not picks:
                return None
            sigma[key] = picks[0]
        elif both.gt is not None or both.lt is not None:
            n = int(both.gt) + 1 if both.gt is not None else int(both.lt) - 1
            if not both.matches(str(n)):
                return None
            sigma[key] = str(n)
        else:
            if not both.matches(gen):
                return None
            sigma[key] = gen
    return sigma


def _custom_keys_ok(reqs: Requirements, pool_labels: Mapping[str, str]) -> bool:
    """Exact host-side check of constraints on keys the lattice does not
    model: they must be satisfied by the pool's template labels (or tolerate
    absence)."""
    for key in reqs.keys():
        if not _is_custom_key(key):
            continue
        c = reqs.get(key)
        if key in pool_labels:
            if not c.matches(pool_labels[key]):
                return False
        elif not c.allows_absent:
            return False
    return True


def csi_claims_count(claims, pvcs: Mapping, storage_classes: Mapping,
                     warnings: Optional[List[str]] = None) -> int:
    """CSI volume attach slots the claims in ``claims`` consume. The core
    scheduler counts a node's CSI volumes against the CSINode attach limit
    (reference troubleshooting.md:277-288 'Pods using PVCs can hit volume
    limits'); deprecated in-tree plugins publish no limits, so the
    reference logs an error and cannot enforce them
    (troubleshooting.md:290-294) — mirrored here as a warning + exclusion.
    Unknown PVCs/StorageClasses count one slot each (almost certainly CSI;
    over-counting is the safe direction for attach limits). Pass a SET of
    claim names for per-unique-volume accounting (resident pods sharing a
    claim attach it once, state/cluster.py existing_bins); pending-group
    charging is per pod-claim reference — a conservative approximation,
    since the resource-axis encoding cannot dedup across groups inside
    the kernel."""
    n = 0
    for cname in claims:
        pvc = pvcs.get(cname)
        sc = (storage_classes.get(pvc.storage_class)
              if pvc is not None and pvc.storage_class else None)
        if sc is not None and sc.provisioner in IN_TREE_PROVISIONERS:
            if warnings is not None:
                warnings.append(
                    f"PVC {cname!r} uses deprecated in-tree plugin "
                    f"{sc.provisioner!r}: attach limits unknown and not "
                    "enforced; use the CSI driver")
            continue
        n += 1
    return n


def _volume_zone_mask(pod: Pod, pvcs: Mapping, storage_classes: Mapping,
                      zones: Sequence[str], warnings: List[str],
                      shared_pins: Optional[Mapping] = None) -> np.ndarray:
    """Zone restriction from the pod's PVC references (reference
    scheduling.md:389-398): a bound PV pins its exact zone; an unbound claim
    restricts to its StorageClass's allowedTopologies (if any).

    ``shared_pins`` maps unbound claims with multiple same-batch consumers
    to ONE pre-chosen zone index (the reference 'randomly selects' a zone
    for WaitForFirstConsumer claims) so consumers can never diverge across
    zones and then fight over the bind. The pin is chosen globally in
    build_problem from the intersection of every consumer's allowed zones."""
    mask = np.ones((len(zones),), dtype=bool)
    zone_index = {z: i for i, z in enumerate(zones)}
    for cname in pod.volume_claims:
        pvc = pvcs.get(cname)
        if pvc is None:
            warnings.append(f"pod references unknown PVC {cname!r}")
            continue
        if pvc.bound_zone is not None:
            m = np.zeros((len(zones),), dtype=bool)
            zi = zone_index.get(pvc.bound_zone)
            if zi is not None:
                m[zi] = True
            mask &= m
            continue
        sc = storage_classes.get(pvc.storage_class)
        if sc is None:
            if pvc.storage_class:
                warnings.append(
                    f"PVC {cname!r} references unknown StorageClass "
                    f"{pvc.storage_class!r}")
            continue
        if sc.zones:
            m = np.zeros((len(zones),), dtype=bool)
            for z in sc.zones:
                zi = zone_index.get(z)
                if zi is not None:
                    m[zi] = True
            mask &= m
        if shared_pins is not None and cname in shared_pins:
            pin_zi = shared_pins[cname]
            if pin_zi is not None:
                pin = np.zeros((len(zones),), dtype=bool)
                pin[pin_zi] = True
                mask &= pin
    return mask


def _selector_keys(pods: Sequence[Pod], bound_pods: Sequence[BoundPod]) -> frozenset:
    """Label keys referenced by ANY affinity/spread selector in the batch or
    on bound pods. Only these keys affect scheduling semantics, so the group
    signature projects labels onto them — per-pod-unique labels (StatefulSet
    pod names, pod-index) never break deduplication.

    Each pod caches its contribution on itself (Pod.__setattr__ drops the
    cache when a selector field is reassigned); cluster state hands the
    SAME Pod objects to every scheduling pass, so steady-state batches pay
    one dict get per pod — whether the selector containers are shared
    (controller-stamped fixtures) or per-pod unique (anything parsed from
    the API server is its own object)."""
    keys: set = set()
    upd = keys.update

    def fill(p: Pod) -> frozenset:
        mine: set = set()
        for term in p.pod_affinity:
            mine.update(k for k, _ in term.label_selector)
        for c in p.topology_spread:
            mine.update(k for k, _ in c.label_selector)
        out = frozenset(mine)
        p.__dict__["_kpat_selkeys"] = out
        return out

    # the emptiness check and the cache hit live INLINE in the loop:
    # most pods carry no selectors at all, and 50k no-op FUNCTION CALLS
    # alone cost ~12 ms of the build budget. The instance __dict__ is
    # read directly: a plain attribute load first scans the type (miss —
    # default_factory fields leave no class attribute) before the
    # instance dict, and at 50k pods the two skipped type scans per pod
    # are another measurable slice of the build budget. ``.get`` (not
    # indexing): a Pod built without __init__ (object.__new__ +
    # piecemeal assignment, serde fast paths, test doubles) may lack the
    # keys entirely, and a missing selector field must read as "no
    # selectors", not KeyError.
    for p in pods:
        d = p.__dict__
        if d.get("pod_affinity") or d.get("topology_spread"):
            cached = d.get("_kpat_selkeys")
            upd(cached if cached is not None else fill(p))
    for bp in bound_pods:
        d = bp.pod.__dict__
        if d.get("pod_affinity") or d.get("topology_spread"):
            cached = d.get("_kpat_selkeys")
            upd(cached if cached is not None else fill(bp.pod))
    return frozenset(keys)


def _group_key(pod: Pod, relevant_keys: frozenset, memo: dict) -> tuple:
    """Cheap per-pod scheduling-signature key over RAW hashable fields.

    All the fields that feed group compilation are here verbatim, so equal
    keys imply identical compiled groups (the expensive requirements /
    mask / topology work runs once per distinct key, not once per pod —
    this is what keeps 50k-pod tensorization in the tens of milliseconds).
    Field order is preserved rather than sorted: pods stamped out by the
    same controller share the construction order, and a differing order
    merely splits a group, never merges distinct ones.

    ``memo`` collapses repeated container objects (pods stamped out from a
    deployment template share the same requests/selector dicts) to one
    tuple build each; holding the container ref keeps its id() stable.
    """

    def t(container) -> tuple:
        if not container:
            return ()
        e = memo.get(id(container))
        if e is not None and e[0] is container:
            return e[1]
        out = (tuple(container.items()) if isinstance(container, dict)
               else tuple(container))
        memo[id(container)] = (container, out)
        return out

    labels = pod.labels
    lab = (tuple(sorted((k, v) for k, v in labels.items() if k in relevant_keys))
           if relevant_keys and labels else ())
    return (
        t(pod.requests),
        lab,
        t(pod.node_selector),
        t(pod.required_affinity),
        t(pod.preferred_affinity),
        t(pod.tolerations),
        t(pod.topology_spread),
        t(pod.pod_affinity),
        t(pod.volume_claims),
    )


# Global signature interning. A pod's full scheduling signature (the nested
# tuple _group_key builds) maps to a small int once per process; the per-pod
# cache stores (relevant_keys, sig_id) so repeated scheduling passes over the
# same pods cost one dict hit + one pointer compare per pod — int-keyed group
# lookup instead of re-hashing nested tuples. Both registries are bounded by
# the number of DISTINCT pod shapes seen, not pod count; shapes can still
# churn over a long-lived controller (rollout-hash-style labels), so the
# registries reset at _INTERN_MAX. build_problem serializes on _INTERN_LOCK:
# two concurrent misses must not mint one sig_id for two signatures, and a
# reset must not yank sig_ids out from under a mid-flight grouping pass
# (stale per-pod caches miss via the interned relevant_keys pointer).
_INTERN_LOCK = threading.Lock()
_INTERN_MAX = 1 << 20
_RK_INTERN: Dict[frozenset, frozenset] = {}
_SIG_IDS: Dict[tuple, int] = {}
_SIG_TUPLES: List[tuple] = []        # sig_id -> sig (for the id->key map)
_BAD_SIDS: Dict[int, str] = {}       # sig_id -> unknown-resource reason
                                     # (depends only on the sig's requests)


def signature_of(pod: Pod, relevant_keys: frozenset = frozenset()
                 ) -> Tuple[str, Optional[str]]:
    """(signature repr, unknown-resource reason) of one pod under the
    given relevant label keys — the SAME interned signature machinery
    build_problem groups with, so solver/incremental.py can match a
    churned pod to the previous build's groups without a full regroup.
    Serializes on the intern lock; the per-pod cache makes repeat calls
    one dict hit."""
    with _INTERN_LOCK:
        rk = _RK_INTERN.setdefault(relevant_keys, relevant_keys)
        cache = pod.__dict__.get("_kpat_sig")
        if cache is not None and cache[0] is rk:
            sid = cache[1]
        else:
            sig = _group_key(pod, rk, {})
            sid = _SIG_IDS.get(sig)
            if sid is None:
                sid = len(_SIG_TUPLES)
                _SIG_IDS[sig] = sid
                _SIG_TUPLES.append(sig)
                _, unknown = resources_to_vec_checked(pod.requests,
                                                      implicit_pod=True)
                if unknown:
                    _BAD_SIDS[sid] = taxonomy.reason(
                        taxonomy.UNKNOWN_RESOURCE,
                        f"unknown resource(s): {', '.join(unknown)}")
            pod.__dict__["_kpat_sig"] = (rk, sid)
        return repr(_SIG_TUPLES[sid]), _BAD_SIDS.get(sid)


def recheck_narrow(group: PodGroup, count: int, total_pending: int,
                   lattice: Lattice) -> bool:
    """Would a from-scratch build reach the SAME narrowing decision for
    ``group`` at the new (count, total_pending)? The incremental builder
    (solver/incremental.py) calls this for every retained group — the
    expensive candidate reductions are content-cached, so the replay is
    one dict hit plus the cheap floor/gain step. False means the drifted
    counts flipped a narrowing decision and the caller must rebuild from
    scratch (parity over speed, always)."""
    ctx = getattr(group, "_narrow_ctx", None)
    if ctx is None:
        # narrowing never ran for this group (narrow=False build);
        # nothing count-dependent to flip
        return True
    (nkey, vec, tmask, zm, cm, pool_tmask, ds_max, existing_tmask,
     prev_raw) = ctx
    with _INTERN_LOCK:
        slot = _NARROW_CACHE.get(id(lattice))
        if slot is not None and slot[0] is not lattice:
            slot = None
        entry = slot[1].get(nkey) if slot is not None else None
        if entry is None:
            a_accel = _accel_bin_cap(vec, tmask, zm, cm, pool_tmask,
                                     existing_tmask, lattice)
            entry = [a_accel, _WAVE_UNSET]
            if slot is None:
                if len(_NARROW_CACHE) >= _NARROW_LATS:
                    _NARROW_CACHE.clear()
                slot = (lattice, {})
                _NARROW_CACHE[id(lattice)] = slot
            if len(slot[1]) >= _NARROW_MAX:
                slot[1].clear()
            slot[1][nkey] = entry
        if entry[0] is not None:
            new_raw = entry[0]
        elif (count >= _WAVE_MIN_PODS and ds_max is not None
                and pool_tmask.any()):
            if entry[1] is _WAVE_UNSET:
                entry[1] = _wave_candidates(vec, tmask, zm, cm, pool_tmask,
                                            ds_max, lattice)
            new_raw = (None if entry[1] is None
                       else _wave_mask_from_table(
                           entry[1], count, tmask, existing_tmask,
                           group.max_per_bin, total_pending))
        else:
            new_raw = None
    if prev_raw is None or new_raw is None:
        return prev_raw is None and new_raw is None
    return bool(np.array_equal(prev_raw, new_raw))


def _group_ledger(cap, g: PodGroup, np_type: np.ndarray,
                  np_zone: np.ndarray, np_cap: np.ndarray, NP: int):
    """One group's constraint-elimination ledger (solver/explain.py).
    O(stages) dot products over [T] per group — the per-pattern offering
    counts are memoized inside ``cap``, so same-shaped groups share
    every reduction."""
    vec, req_tmask, zm, cm = g._explain_ctx
    lattice = cap.lattice
    fits_t = (lattice.alloc >= vec[None, :]).all(axis=1)
    if g.np_ok.any():
        ptm = np_type[g.np_ok].any(axis=0)
        pzm = np_zone[g.np_ok].any(axis=0)
        pcm = np_cap[g.np_ok].any(axis=0)
    else:
        ptm = np.zeros(np_type.shape[1], dtype=bool)
        pzm = np.zeros(np_zone.shape[1], dtype=bool)
        pcm = np.zeros(np_cap.shape[1], dtype=bool)
    final = g.type_mask if g.unnarrowed_type_mask is not None else None
    notes: List[str] = []
    if g.single_bin:
        notes.append("hostname self-affinity: all replicas co-locate")
    if g.spread_class >= 0:
        notes.append(f"hostname spread: at most {g.max_per_bin} per node")
    elif g.max_per_bin < _BIG:
        notes.append(f"per-node cap: at most {g.max_per_bin}")
    if g.strict_custom:
        notes.append("strict custom-key constraints")
    if g.need is not None and g.need.any():
        notes.append("requires a co-located affinity class")
    if g.owner is not None and g.owner.any():
        notes.append("owns a hostname anti-affinity term")
    return cap.ledger(vec, fits_t, req_tmask, zm, cm, ptm, pzm, pcm,
                      final, g.signature, len(g.pod_names),
                      int(g.np_ok.sum()), NP, notes)


def build_problem(pods: Sequence[Pod], node_pools: Sequence[NodePool], lattice: Lattice,
                  existing: Sequence[ExistingBin] = (),
                  daemonset_pods: Sequence[Pod] = (),
                  bound_pods: Sequence[BoundPod] = (),
                  pvcs: Optional[Mapping] = None,
                  storage_classes: Optional[Mapping] = None,
                  pool_headroom: Optional[Mapping[str, np.ndarray]] = None,
                  narrow: bool = True, explain: bool = False) -> Problem:
    with _INTERN_LOCK:
        if len(_SIG_TUPLES) >= _INTERN_MAX:
            _RK_INTERN.clear()
            _SIG_IDS.clear()
            _SIG_TUPLES.clear()
            _BAD_SIDS.clear()
        return _build_problem(pods, node_pools, lattice, existing,
                              daemonset_pods, bound_pods, pvcs,
                              storage_classes, pool_headroom, narrow,
                              explain)


def _build_problem(pods: Sequence[Pod], node_pools: Sequence[NodePool], lattice: Lattice,
                   existing: Sequence[ExistingBin] = (),
                   daemonset_pods: Sequence[Pod] = (),
                   bound_pods: Sequence[BoundPod] = (),
                   pvcs: Optional[Mapping] = None,
                   storage_classes: Optional[Mapping] = None,
                   pool_headroom: Optional[Mapping[str, np.ndarray]] = None,
                   narrow: bool = True, explain: bool = False) -> Problem:
    real_pools = sorted(node_pools, key=lambda p: (-p.weight, p.name))
    T, Z, C = lattice.T, lattice.Z, lattice.C
    key_values = lattice.key_values_present()
    warnings: List[str] = []
    # pool masks build AFTER grouping: groups' custom-key demands against
    # pool-requirement-offered keys (Exists / In with free values) expand
    # the pool list with virtual labeled variants first (see below)

    # --- group pods by scheduling signature (one expensive compile per
    # distinct key; the per-pod loop is one dict hit + one pointer compare)
    unschedulable: Dict[str, str] = {}
    raw_groups: Dict[int, Tuple[Pod, List[str]]] = {}   # sig_id -> (rep, names)
    bad_claims: Dict[str, int] = {}   # PVC refs of unknown-resource pods
    order: List[int] = []
    relevant_keys = _selector_keys(pods, bound_pods)
    relevant_keys = _RK_INTERN.setdefault(relevant_keys, relevant_keys)
    memo: dict = {}
    # three-level grouping, fastest first:
    # 1. the per-pod cache (rk, sig_id) stored on the Pod — cluster state
    #    hands the SAME Pod objects to every scheduling pass (and every
    #    relaxation round), so after the first pass each pod costs one dict
    #    get and one pointer compare. Pod.__setattr__ drops the cache when
    #    any scheduling field is reassigned; relevant-keys changes miss on
    #    the interned rk pointer.
    # 2. an identity tuple over the field containers — pods stamped out from
    #    one controller template share the same requests/selector OBJECTS,
    #    so first-pass grouping needs no content hashing (identity is
    #    verified with `is` before use, so a recycled id() can never
    #    mis-group).
    # 3. the full content key (_group_key), interned to a small int.
    coarse: Dict[tuple, tuple] = {}   # identity key -> (rep pod, names or None)
    lab_rel = bool(relevant_keys)
    _SIG = "_kpat_sig"
    # bound `names.append` per live sid: the steady-state per-pod cost is
    # one dict get on the pod + one pointer compare + one dict get here +
    # one call — no tuple index or method-attribute lookup per pod (at
    # 50k pods those two extra ops alone are ~10 ms of the build budget)
    appenders: Dict[int, Any] = {}
    ap_get = appenders.get
    bad_get = _BAD_SIDS.get
    # run fast path: template-mates SHARE one cache tuple (the coarse
    # path below installs the rep's tuple on every mate), and waves
    # arrive in template order — a pointer match on the previous pod's
    # cache skips even the sid/appender lookups, leaving one dict get,
    # one `is`, and one append for most of a steady 50k wave (~5 ms off
    # the cfg5 build budget). Never armed for bad sids.
    prev_cache: Any = None
    prev_ap: Any = None
    for pod in pods:
        cache = pod.__dict__.get(_SIG)
        if cache is not None:
            if cache is prev_cache:
                prev_ap(pod.name)
                continue
            if cache[0] is relevant_keys:
                sid = cache[1]
                ap = ap_get(sid)
                if ap is not None:
                    prev_cache = cache
                    prev_ap = ap
                    ap(pod.name)
                    continue
                reason = bad_get(sid)
                if reason is not None:
                    unschedulable[pod.name] = reason
                    for c in pod.volume_claims:
                        bad_claims[c] = bad_claims.get(c, 0) + 1
                    continue
                names = [pod.name]
                raw_groups[sid] = (pod, names)
                ap = names.append
                appenders[sid] = ap
                prev_cache = cache
                prev_ap = ap
                order.append(sid)
                continue
        ck = (id(pod.requests) if pod.requests else 0,
              id(pod.node_selector) if pod.node_selector else 0,
              id(pod.required_affinity) if pod.required_affinity else 0,
              id(pod.preferred_affinity) if pod.preferred_affinity else 0,
              id(pod.tolerations) if pod.tolerations else 0,
              id(pod.topology_spread) if pod.topology_spread else 0,
              id(pod.pod_affinity) if pod.pod_affinity else 0,
              id(pod.volume_claims) if pod.volume_claims else 0,
              id(pod.labels) if (lab_rel and pod.labels) else 0)
        hit = coarse.get(ck)
        if hit is not None:
            rep, names = hit
            if (names is not None
                    and (not pod.requests or rep.requests is pod.requests)
                    and (not pod.node_selector or rep.node_selector is pod.node_selector)
                    and (not pod.required_affinity or rep.required_affinity is pod.required_affinity)
                    and (not pod.preferred_affinity or rep.preferred_affinity is pod.preferred_affinity)
                    and (not pod.tolerations or rep.tolerations is pod.tolerations)
                    and (not pod.topology_spread or rep.topology_spread is pod.topology_spread)
                    and (not pod.pod_affinity or rep.pod_affinity is pod.pod_affinity)
                    and (not pod.volume_claims or rep.volume_claims is pod.volume_claims)
                    and (not (lab_rel and pod.labels) or rep.labels is pod.labels)):
                names.append(pod.name)
                rc = rep.__dict__.get(_SIG)
                if rc is not None and rc[0] is relevant_keys:
                    pod.__dict__[_SIG] = rc
                continue
        sig = _group_key(pod, relevant_keys, memo)
        sid = _SIG_IDS.get(sig)
        if sid is None:
            sid = len(_SIG_TUPLES)
            _SIG_IDS[sig] = sid
            _SIG_TUPLES.append(sig)
            _, unknown = resources_to_vec_checked(pod.requests, implicit_pod=True)
            if unknown:
                _BAD_SIDS[sid] = taxonomy.reason(
                    taxonomy.UNKNOWN_RESOURCE,
                    f"unknown resource(s): {', '.join(unknown)}")
        pod.__dict__[_SIG] = (relevant_keys, sid)
        entry = raw_groups.get(sid)
        if entry is not None:
            entry[1].append(pod.name)
            if hit is None:
                coarse[ck] = (pod, entry[1])
            continue
        reason = _BAD_SIDS.get(sid)
        if reason is not None:
            unschedulable[pod.name] = reason
            for c in pod.volume_claims:
                bad_claims[c] = bad_claims.get(c, 0) + 1
            continue
        names = [pod.name]
        raw_groups[sid] = (pod, names)
        appenders[sid] = names.append
        order.append(sid)
        if hit is None:
            coarse[ck] = (pod, names)

    # unbound claims with multiple same-batch consumers pin to one zone,
    # chosen from the intersection of EVERY consumer's allowed zones (its
    # node-selector/affinity zone constraints plus its other claims' bound
    # zones) — a per-consumer first-eligible pick would diverge or falsely
    # exclude consumers whose own constraints forbid the picked zone
    # consumer counts come from the groups (all pods of a group share the
    # same claims list — it is part of the signature) plus the rare
    # unknown-resource pods tallied during the scan
    claim_refs: Dict[str, int] = dict(bad_claims)
    for sid in order:
        rep, names = raw_groups[sid]
        for c in rep.volume_claims:
            claim_refs[c] = claim_refs.get(c, 0) + len(names)
    shared_pins: Dict[str, Optional[int]] = {}
    shared = [c for c, n in claim_refs.items() if n > 1
              and pvcs and c in pvcs and pvcs[c].bound_zone is None]
    if shared:
        inter: Dict[str, np.ndarray] = {}
        scratch: List[str] = []
        for sid in order:
            rep, _names = raw_groups[sid]
            touches = [c for c in rep.volume_claims if c in shared]
            if not touches:
                continue
            m = compile_masks(rep.scheduling_requirements(), lattice,
                              skip_unresolved_custom=True).zone_mask
            m = m & _volume_zone_mask(rep, pvcs or {}, storage_classes or {},
                                      lattice.zones, scratch)
            for c in touches:
                inter[c] = m if c not in inter else (inter[c] & m)
        for c, m in inter.items():
            elig = np.nonzero(m)[0]
            if elig.size:
                shared_pins[c] = int(elig[0])
            else:
                shared_pins[c] = None
                warnings.append(
                    f"consumers of shared unbound PVC {c!r} have no common "
                    f"eligible zone; the volume can only bind for some of them")

    # --- virtual-pool expansion for custom-key label assignment
    # (reference scheduling.md:536-556, the Exists-operator workload
    # segregation): a pool whose TEMPLATE REQUIREMENT covers a custom key
    # (Exists, or In with several values) leaves the node's label value
    # free; a group demanding a concrete value gets a virtual variant of
    # that pool whose merged labels pin it. Bins then separate by value
    # through ordinary pool identity — conflicting groups can never share
    # a node — and everything downstream (np masks, weight order, claim
    # labels) treats the variant as just another pool. Limits, budgets,
    # and the drift hash roll up to ``base_name``.
    pool_reqs_real = [p.scheduling_requirements() for p in real_pools]

    # custom-key spread domains: every value a NodePool names for the key
    # (In-requirement values or a template label) — the reference
    # discovers spread domains from its NodePools the same way
    # (scheduling.md:312-446, :558-614 'virtual domains'). Values found
    # only on live nodes do NOT become split domains: no pool can launch
    # into them, so pinning a slice there would strand it (existing
    # matching pods still COUNT into the water-fill via bound_pods).
    custom_domains: Dict[str, List[str]] = {}

    def _add_domain(key: str, val: str) -> None:
        if _is_custom_key(key):
            vals = custom_domains.setdefault(key, [])
            if val not in vals:
                vals.append(val)
    for pool, preqs in zip(real_pools, pool_reqs_real):
        for key in preqs.keys():
            if _is_custom_key(key):
                c = preqs.get(key)
                if c.include:
                    for v in sorted(c.include):
                        _add_domain(key, v)
        for k, v in pool.labels.items():
            _add_domain(k, v)
        # effective template labels are domain sources too: every node of
        # a windows pool carries the build label even when the pool never
        # names it (mirrors the pool_eff_labels stamping below)
        if (pool_os(pool) == "windows"
                and wk.LABEL_WINDOWS_BUILD not in pool.labels):
            _add_domain(wk.LABEL_WINDOWS_BUILD, WINDOWS_BUILD)

    virtual: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], NodePool] = {}

    def _ensure_virtual(pool: NodePool, sigma: Dict[str, str]) -> None:
        vkey = (pool.name, tuple(sorted(sigma.items())))
        if vkey not in virtual:
            import dataclasses
            virtual[vkey] = dataclasses.replace(
                pool,
                name=pool.name + "@" + ",".join(
                    f"{k}={v}" for k, v in sorted(sigma.items())),
                labels={**pool.labels, **sigma},
                base_name=pool.base_name or pool.name,
                custom_labels=dict(sigma))

    for sid in order:
        rep, _names = raw_groups[sid]
        reqs = rep.scheduling_requirements()
        # generated value for existence-only demands: stable across passes
        # (content-derived, NOT the volatile group ordinal — otherwise a
        # later batch pins a different value and can never rejoin the node
        # the first batch labeled); the reference stamps a random label
        import hashlib
        gen = "kpat-" + hashlib.sha1(
            repr(_SIG_TUPLES[sid]).encode()).hexdigest()[:8]
        base_sigmas: Dict[str, Dict[str, str]] = {}
        if any(_is_custom_key(k) for k in reqs.keys()):
            for pool, preqs in zip(real_pools, pool_reqs_real):
                sigma = _resolve_custom_sigma(reqs, pool, preqs, gen)
                if sigma:
                    _ensure_virtual(pool, sigma)
                if sigma is not None:
                    base_sigmas[pool.name] = sigma
        # a DoNotSchedule spread over a custom key pins each slice to one
        # domain value: pre-materialize the per-domain pool variants,
        # COMPOSED with the group's own demand sigma (a group can pin
        # team=a and spread over rack at the same time)
        for c in rep.topology_spread:
            key = c.topology_key
            if not _is_custom_key(key) or c.when_unsatisfiable == "ScheduleAnyway":
                continue
            for d in custom_domains.get(key, ()):
                for pool, preqs in zip(real_pools, pool_reqs_real):
                    if key in pool.labels:
                        continue  # fixed-label pool serves its own domain
                    if key in set(preqs.keys()) and preqs.get(key).matches(d):
                        base = base_sigmas.get(pool.name, {})
                        if key in base:
                            continue  # demand already pins this key
                        _ensure_virtual(pool, {**base, key: d})
    # '@' sorts before alphanumerics, so on equal weight the REAL pool
    # still precedes its variants... actually '@'(0x40) < 'a', but the
    # real name is a strict prefix and strings compare prefix-first, so
    # "default" < "default@k=v": unconstrained groups keep preferring the
    # unlabeled base pool
    pools = sorted(list(real_pools) + list(virtual.values()),
                   key=lambda p: (-p.weight, p.name))
    NP = len(pools)

    # --- NodePool masks + daemonset overhead
    np_type = np.ones((NP, T), dtype=bool)
    np_zone = np.ones((NP, Z), dtype=bool)
    np_cap = np.ones((NP, C), dtype=bool)
    ds_overhead = np.zeros((NP, R), dtype=np.float32)
    np_alloc_cap = np.full((NP, R), np.inf, dtype=np.float32)
    # per-daemonset request vectors, computed ONCE (not per pool — the
    # csi_claims_count warning side effect must fire once per solve):
    # a daemonset mounting CSI PVCs consumes an attach slot on EVERY
    # node it lands on, so its overhead vector charges the axis like
    # pending groups do
    ds_prepared: List[Tuple[Pod, np.ndarray]] = []
    for ds in daemonset_pods:
        vec, unknown = resources_to_vec_checked(ds.requests, implicit_pod=True)
        if unknown:
            continue
        if ds.volume_claims:
            vec[res_axis("attachable-volumes")] = csi_claims_count(
                ds.volume_claims, pvcs or {}, storage_classes or {}, warnings)
        ds_prepared.append((ds, vec))
    pool_reqs: List[Requirements] = []
    pool_eff_labels: List[Mapping[str, str]] = []
    for pi, pool in enumerate(pools):
        if pool.kubelet is not None and pool.kubelet.max_pods is not None:
            # kubelet maxPods caps the pods axis of every node the pool
            # launches, below the ENI-derived density (reference
            # nodepools CRD spec.template.spec.kubelet)
            np_alloc_cap[pi, res_axis("pods")] = float(pool.kubelet.max_pods)
        reqs = pool.scheduling_requirements()
        # nodes of a pool boot ONE concrete OS (the AMI family's;
        # pool_os resolves it, default linux) — pin the pool's os
        # constraint to exactly that value so pod-vs-pool compatibility
        # and the launched node's label can never disagree, whatever
        # shape the user's os requirement took
        p_os = pool_os(pool)
        reqs = reqs.merge(Requirements(
            [Requirement(wk.LABEL_OS, Operator.IN, (p_os,))]))
        pool_reqs.append(reqs)
        # a pool's OWN value-free custom-key requirements (Exists / In on
        # user keys) are label templates its nodes will carry — never
        # lattice constraints; they must not zero the pool's masks
        # effective template labels: every windows node carries the
        # build label (cloudprovider.create stamps it), so pods selecting
        # on it resolve against this pool like any template label —
        # WITHOUT mutating the user's NodePool object
        eff = pool.labels
        if p_os == "windows" and wk.LABEL_WINDOWS_BUILD not in eff:
            eff = {**eff, wk.LABEL_WINDOWS_BUILD: WINDOWS_BUILD}
        pool_eff_labels.append(eff)
        m = compile_masks(reqs, lattice, extra_labels=eff,
                          skip_unresolved_custom=True)
        np_type[pi], np_zone[pi], np_cap[pi] = m.type_mask, m.zone_mask, m.cap_mask
        if pool_headroom is not None:
            # remaining limit budget caps a NEW node's size at solve time
            # (the reference narrows an in-flight node's instance-type
            # options as the pool approaches spec.limits) — limits roll up
            # to the base pool for virtual variants. The charge a node
            # makes against the limit is its CLAMPED capacity (kubelet
            # maxPods lowers the pods axis), so compare the clamped value
            rem = pool_headroom.get(pool.base_name or pool.name)
            if rem is not None:
                eff_capacity = np.minimum(lattice.capacity,
                                          np_alloc_cap[pi][None, :])
                np_type[pi] &= np.all(eff_capacity <= rem[None, :] + 1e-6,
                                      axis=1)
        for ds, vec in ds_prepared:
            # a daemonset lands on the pool's nodes iff it tolerates the pool
            # taints and its node selectors are compatible (reference
            # resolves daemonset overhead per simulated node the same way)
            # startupTaints clear before steady state: a daemonset still
            # runs (and costs overhead) on the pool's nodes even without
            # tolerating them (reference nodepools.md:484)
            if not tolerates_all(ds.tolerations, pool.taints):
                continue
            # hard rules only: a daemonset's zone/node PREFERENCE must not
            # drop its overhead from nodes it would still run on (in real
            # k8s the DS schedules there regardless; sizing must include it)
            ds_reqs = ds.hard_scheduling_requirements()
            if not ds_reqs.compatible_with(reqs):
                continue
            if not _custom_keys_ok(ds_reqs, pool_eff_labels[pi]):
                continue
            ds_overhead[pi] += vec

    # accelerator-capable EXISTING node types (see _accel_bin_cap: their
    # free capacity must stay joinable through any narrowed group mask)
    existing_tmask = np.zeros((T,), dtype=bool)
    for b in existing:
        ti = lattice.name_to_idx.get(b.instance_type)
        if ti is not None:
            existing_tmask[ti] = True

    # --- per raw group: masks, pool compatibility, topology resolution
    registry = ClassRegistry()
    # bound pods' hostname anti-affinity terms must be classes too — the k8s
    # symmetry check keeps pending matches OFF nodes whose resident pods own
    # such terms, even when no pending pod references the selector
    for bp in bound_pods:
        for term in bp.pod.pod_affinity:
            if term.anti and term.topology_key == wk.LABEL_HOSTNAME:
                registry.intern(tuple(term.label_selector))
    groups: List[PodGroup] = []
    pending_topo: List[Tuple[PodGroup, Pod, np.ndarray, np.ndarray]] = []  # group, rep, owner, need
    pending_spread_counts: Dict = {}  # (selector, key) -> planned per-domain adds
    for sid in order:
        rep, names = raw_groups[sid]
        sig = _SIG_TUPLES[sid]
        vec, _ = resources_to_vec_checked(rep.requests, implicit_pod=True)
        if rep.volume_claims:
            vec[res_axis("attachable-volumes")] = csi_claims_count(
                rep.volume_claims, pvcs or {}, storage_classes or {}, warnings)
        reqs = rep.scheduling_requirements()
        # custom-key constraints resolve exactly per-pool in np_ok below
        masks = compile_masks(reqs, lattice, skip_unresolved_custom=True)
        np_ok = np.zeros((NP,), dtype=bool)
        for pi, pool in enumerate(pools):
            # directional: pod requirements vs the pool's node template
            if not reqs.compatible_with(pool_reqs[pi]):
                continue
            # pods are NOT required to tolerate startupTaints — they are
            # temporary and cleared by an init daemon before steady-state
            # scheduling (reference nodepools.md:60-64,484: "pods aren't
            # required to tolerate these taints to be considered")
            if not tolerates_all(rep.tolerations, pool.taints):
                continue
            if not _custom_keys_ok(reqs, pool_eff_labels[pi]):
                continue
            merged = reqs.merge(pool_reqs[pi])
            if not merged.min_values_satisfied(key_values):
                continue
            np_ok[pi] = True
        strict = any(
            _is_custom_key(key) and not reqs.get(key).allows_absent
            for key in reqs.keys()
        )
        # unknown-pool existing bins (their NodePool is gone) are treated
        # as linux, the sim's universal default: a group whose os
        # constraint excludes linux must stay off them exactly like a
        # strict custom key (known-pool bins resolve os through np_ok)
        if wk.LABEL_OS in reqs.keys() \
                and not reqs.get(wk.LABEL_OS).matches("linux"):
            strict = True

        zone_mask_eff = masks.zone_mask
        if rep.volume_claims:
            zone_mask_eff = zone_mask_eff & _volume_zone_mask(
                rep, pvcs or {}, storage_classes or {}, lattice.zones, warnings,
                shared_pins=shared_pins)
        splits, topo, cut = resolve_group_topology(
            rep, len(names), zone_mask_eff, masks.cap_mask,
            lattice.zones, lattice.capacity_types, registry, bound_pods, warnings,
            pending_counts=pending_spread_counts,
            custom_domains=custom_domains)
        if cut > 0:
            for name in names[len(names) - cut:]:
                unschedulable[name] = taxonomy.reason(
                    taxonomy.ZONE_ANTI_AFFINITY,
                    "more replicas than eligible zones")
            names = names[: len(names) - cut]
        cursor = 0
        for s in splits:
            sub_names = names[cursor: cursor + s.count]
            cursor += s.count
            if not sub_names:
                continue
            np_ok_s = np_ok
            if s.custom:
                # custom-spread slice: only pools whose EFFECTIVE labels
                # (template labels + derived well-knowns like windows-build,
                # same map _custom_keys_ok resolves against) carry exactly
                # this slice's domain values may host it
                np_ok_s = np_ok & np.array(
                    [all(eff.get(k) == v for k, v in s.custom.items())
                     for eff in pool_eff_labels], dtype=bool)
            g_tmask = masks.type_mask
            unnarrowed = None
            narrow_ctx = None
            if narrow and not topo.single_bin:
                # accelerator bin-splitting (see _accel_bin_cap) — never
                # applied over hostname self-affinity's one-bin contract.
                # Ranking sees only offerings SOME compatible pool can
                # launch (union of pool type/zone/captype masks); the
                # feasibility gate below still holds the pre-narrowing
                # mask as a fallback for per-pool interactions the union
                # can't capture.
                any_pool = bool(np_ok_s.any())
                if any_pool:
                    pool_tmask = np_type[np_ok_s].any(axis=0)
                    pool_zmask = np_zone[np_ok_s].any(axis=0)
                    pool_cmask = np_cap[np_ok_s].any(axis=0)
                else:
                    pool_tmask = np.zeros(T, dtype=bool)
                    pool_zmask = np.zeros(Z, dtype=bool)
                    pool_cmask = np.zeros(C, dtype=bool)
                zm = s.zone_mask & pool_zmask
                cm = s.cap_mask & pool_cmask
                # heaviest compatible pool's daemonset overhead: ranking
                # with it keeps small types from being over-favored
                ds_max = (ds_overhead[np_ok_s].max(axis=0)
                          if any_pool else None)
                # the cached entry is COUNT-INDEPENDENT (accel mask +
                # wave candidate table); the cheap floor/gain decision
                # below re-runs per call so pod-count drift between
                # steady-state passes neither misses the cache nor
                # diverges from a from-scratch rebuild
                nkey = (lattice.price_version, vec.tobytes(),
                        masks.type_mask.tobytes(), zm.tobytes(),
                        cm.tobytes(), pool_tmask.tobytes(),
                        existing_tmask.tobytes(),
                        ds_max.tobytes() if ds_max is not None else b"")
                slot = _NARROW_CACHE.get(id(lattice))
                if slot is not None and slot[0] is not lattice:
                    slot = None                     # id reuse: stale slot
                entry = slot[1].get(nkey) if slot is not None else None
                if entry is None:
                    a_accel = _accel_bin_cap(
                        vec, masks.type_mask, zm, cm, pool_tmask,
                        existing_tmask, lattice)
                    # the wave table fills LAZILY (below): a batch of
                    # thousands of sub-threshold singleton groups must
                    # not pay the candidate reductions it will never use
                    entry = [a_accel, _WAVE_UNSET]
                    if slot is None:
                        if len(_NARROW_CACHE) >= _NARROW_LATS:
                            _NARROW_CACHE.clear()
                        slot = (lattice, {})
                        _NARROW_CACHE[id(lattice)] = slot
                    if len(slot[1]) >= _NARROW_MAX:
                        slot[1].clear()
                    slot[1][nkey] = entry
                a_accel = entry[0]
                if a_accel is not None:
                    a_mask = a_accel
                elif (len(sub_names) >= _WAVE_MIN_PODS and any_pool
                        and ds_max is not None):
                    # pods-axis-bound wave narrowing (generic groups
                    # only — accel groups are _accel_bin_cap's)
                    if entry[1] is _WAVE_UNSET:
                        entry[1] = _wave_candidates(
                            vec, masks.type_mask, zm, cm, pool_tmask,
                            ds_max, lattice)
                    a_mask = (None if entry[1] is None
                              else _wave_mask_from_table(
                                  entry[1], len(sub_names),
                                  masks.type_mask, existing_tmask,
                                  topo.max_per_bin, len(pods)))
                else:
                    a_mask = None
                # retained for solver/incremental.py recheck_narrow: the
                # raw (pre-feasibility-fallback) decision plus every
                # input needed to replay it at a drifted count
                narrow_ctx = (nkey, vec, masks.type_mask, zm, cm,
                              pool_tmask, ds_max, existing_tmask, a_mask)
                if a_mask is not None and a_mask.any():
                    unnarrowed = masks.type_mask
                    g_tmask = a_mask
            g = PodGroup(
                signature=repr(sig), pod_names=sub_names, req=vec,
                type_mask=g_tmask, zone_mask=s.zone_mask, cap_mask=s.cap_mask,
                np_ok=np_ok_s, requirements=reqs,
                max_per_bin=topo.max_per_bin, spread_class=topo.spread_class,
                single_bin=topo.single_bin,
                strict_custom=strict,
                unnarrowed_type_mask=unnarrowed,
            )
            g._narrow_ctx = narrow_ctx
            if explain:
                # the inputs the ledger build (below, after the
                # feasibility gate settles type masks) needs: the request
                # vector and the PRE-narrowing compiled masks
                g._explain_ctx = (vec, masks.type_mask,
                                  s.zone_mask, s.cap_mask)
            groups.append(g)
            pending_topo.append((g, rep, topo.owner, topo.need))

    # --- finalize affinity-class rows at full registry width
    A = registry.A
    for g, rep, owner, need in pending_topo:
        g.match = registry.match_row(rep.labels) if A else np.zeros((0,), dtype=bool)
        g.owner = np.zeros((A,), dtype=bool)
        g.need = np.zeros((A,), dtype=bool)
        if owner is not None and owner.size:
            g.owner[: owner.size] = owner
        if need is not None and need.size:
            g.need[: need.size] = need

    # mark groups with no feasible (pool, type, offering) at all.
    # fast path: when neither the group nor the pool restricts zones or
    # capacity types (the common case), feasibility collapses to one
    # T-wide AND against "type has ANY available offering" — the full
    # [T,Z,C] broadcast only runs for restricted combinations (measured
    # ~3 ms/build at 31 groups on the 759-type catalog otherwise)
    avail_t = lattice.available.any(axis=(1, 2))           # [T]
    np_zone_full = np_zone.all(axis=1)                     # [NP]
    np_cap_full = np_cap.all(axis=1)                       # [NP]

    def _has_offering(g) -> bool:
        g_free = bool(g.zone_mask.all()) and bool(g.cap_mask.all())
        for pi in np.nonzero(g.np_ok)[0]:
            if g_free and np_zone_full[pi] and np_cap_full[pi]:
                if (g.type_mask & np_type[pi] & avail_t).any():
                    return True
                continue
            tm = g.type_mask & np_type[pi]
            zm = g.zone_mask & np_zone[pi]
            cm = g.cap_mask & np_cap[pi]
            if (tm[:, None, None] & zm[None, :, None] & cm[None, None, :]
                    & lattice.available).any():
                return True
        return False

    ledger_cap = None
    if explain:
        from .explain import LedgerCapture
        ledger_cap = LedgerCapture(lattice)
    schedulable_groups: List[PodGroup] = []
    dropped_groups: List[PodGroup] = []
    for g in groups:
        feasible = _has_offering(g)
        if not feasible and g.unnarrowed_type_mask is not None:
            # accel narrowing must never COST schedulability: per-pool
            # interactions (zone pins, ICE, daemonset overhead at pack
            # time) the union-masked ranking can't see fall back to the
            # full mask (the pre-narrowing behavior)
            g.type_mask = g.unnarrowed_type_mask
            g.unnarrowed_type_mask = None
            feasible = _has_offering(g)
        if ledger_cap is not None:
            g.ledger = _group_ledger(ledger_cap, g, np_type, np_zone,
                                     np_cap, NP)
        if feasible or len(existing) > 0:
            # groups infeasible for new nodes may still fit existing capacity
            schedulable_groups.append(g)
        else:
            # the ledger refines the code: every compatible offering
            # eliminated by the ICE/unavailable mask is weather-caused
            # pending (ice-hold), not genuine infeasibility
            code = (g.ledger.blame_code() if g.ledger is not None
                    else "") or taxonomy.NO_OFFERING
            msg = taxonomy.reason(
                code, "all compatible offerings currently unavailable"
                if code == taxonomy.ICE_HOLD
                else "no compatible nodepool/instance-type offering")
            for name in g.pod_names:
                unschedulable[name] = msg
            dropped_groups.append(g)
    groups = schedulable_groups

    # --- FFD order: dominant normalized request, descending (the grouped
    # equivalent of the reference's pods-sorted-by-size FFD loop).
    # Groups with presence requirements (need) must come after potential
    # seeders, so they sort by a secondary "needs-presence" key.
    if groups:
        mean_alloc = np.maximum(lattice.alloc.mean(axis=0), 1e-6)  # [R]
        def ffd_key(g: PodGroup):
            norm = g.req / mean_alloc
            return (bool(g.need.any()), -float(norm.max()), -float(g.req[0]),
                    -float(g.req[1]), g.signature)
        groups.sort(key=ffd_key)

    G = len(groups)
    req = np.stack([g.req for g in groups]) if G else np.zeros((0, R), np.float32)
    count = np.array([len(g.pod_names) for g in groups], dtype=np.int32)
    g_type = np.stack([g.type_mask for g in groups]) if G else np.zeros((0, T), bool)
    g_zone = np.stack([g.zone_mask for g in groups]) if G else np.zeros((0, Z), bool)
    g_cap = np.stack([g.cap_mask for g in groups]) if G else np.zeros((0, C), bool)
    g_np = np.stack([g.np_ok for g in groups]) if G else np.zeros((0, NP), bool)
    max_per_bin = np.array([min(g.max_per_bin, _BIG) for g in groups], dtype=np.int32)
    g_spread = np.array([g.spread_class for g in groups], dtype=np.int32)
    single_bin = np.array([g.single_bin for g in groups], dtype=bool)
    g_match = np.stack([g.match for g in groups]) if G else np.zeros((0, A), bool)
    g_owner = np.stack([g.owner for g in groups]) if G else np.zeros((0, A), bool)
    g_need = np.stack([g.need for g in groups]) if G else np.zeros((0, A), bool)
    strict_custom = np.array([g.strict_custom for g in groups], dtype=bool)

    # --- existing bins
    E = len(existing)
    e_used = np.zeros((E, R), np.float32)
    e_alloc = np.zeros((E, R), np.float32)
    e_type = np.zeros((E,), np.int32)
    e_zone = np.zeros((E,), np.int32)
    e_cap = np.zeros((E,), np.int32)
    e_np = np.full((E,), -1, np.int32)
    e_pm = np.zeros((E, A), np.int32)
    e_po = np.zeros((E, A), bool)
    pool_index = {p.name: i for i, p in enumerate(pools)}
    by_base: Dict[str, List[int]] = {}
    for pi, p in enumerate(pools):
        by_base.setdefault(p.base_name or p.name, []).append(pi)
    zone_index = {z: i for i, z in enumerate(lattice.zones)}
    cap_index = {c: i for i, c in enumerate(lattice.capacity_types)}
    bin_index = {b.name: i for i, b in enumerate(existing)}

    def bin_pool(b: ExistingBin) -> int:
        """The most specific pool variant a bin's node labels realize —
        a node labeled team=a belongs to the team=a virtual variant, so
        groups demanding that value can join it and conflicting groups
        cannot."""
        best, score = pool_index.get(b.node_pool, -1), -1
        for pi in by_base.get(b.node_pool, ()):
            sigma = pools[pi].custom_labels
            if all(b.labels.get(k) == v for k, v in sigma.items()) \
                    and len(sigma) > score:
                best, score = pi, len(sigma)
        return best

    for ei, b in enumerate(existing):
        ti = lattice.name_to_idx[b.instance_type]
        e_used[ei] = b.used
        if b.alloc_override is not None:
            # NaN marks axes the node did not report (canonical_to_vec
            # missing=nan): fall back to the lattice's prediction — e.g.
            # attachable-volumes before the CSINode registers
            ov = b.alloc_override
            e_alloc[ei] = np.where(np.isnan(ov), lattice.alloc[ti], ov)
        else:
            e_alloc[ei] = lattice.alloc[ti]
        e_type[ei] = ti
        e_zone[ei] = zone_index[b.zone]
        e_cap[ei] = cap_index[b.capacity_type]
        e_np[ei] = bin_pool(b)
    # seed affinity-class presence on existing bins from bound pods
    if A:
        for bp in bound_pods:
            ei = bin_index.get(bp.node_name)
            if ei is None:
                continue
            e_pm[ei] += registry.match_row(bp.pod.labels).astype(np.int32)
            for term in bp.pod.pod_affinity:
                if term.anti and term.topology_key == wk.LABEL_HOSTNAME:
                    key = tuple(sorted(term.label_selector))
                    a = registry.index.get(key)
                    if a is not None:
                        e_po[ei, a] = True

    return Problem(
        lattice=lattice, node_pools=pools, groups=groups, existing=list(existing),
        unschedulable=unschedulable,
        req=req.astype(np.float32), count=count, g_type=g_type, g_zone=g_zone,
        g_cap=g_cap, g_np=g_np, max_per_bin=max_per_bin, g_spread=g_spread,
        single_bin=single_bin,
        g_match=g_match, g_owner=g_owner, g_need=g_need, strict_custom=strict_custom,
        warnings=list(dict.fromkeys(warnings)),  # distinct notices once each
        dropped_groups=dropped_groups,
        np_type=np_type, np_zone=np_zone, np_cap=np_cap, ds_overhead=ds_overhead,
        np_alloc_cap=np_alloc_cap,
        e_used=e_used, e_alloc=e_alloc, e_type=e_type, e_zone=e_zone, e_cap=e_cap,
        e_np=e_np, e_pm=e_pm, e_po=e_po,
    )
