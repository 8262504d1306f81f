"""Topology spread + pod (anti-)affinity resolution.

The reference enforces these constraints inside its sequential scheduling
simulation (core provisioner; behavioral spec: reference
website/content/en/preview/concepts/scheduling.md:312-446 — zonal/hostname/
capacity-type topologySpreadConstraints, required podAffinity /
podAntiAffinity). A per-pod simulator can consult mutable domain counters
before every placement; a batched device kernel cannot. The TPU-first
decomposition used here splits each constraint by *topology key*:

- **zone / capacity-type scoped** constraints are resolved HOST-SIDE, before
  the scan, by splitting a pod group into per-domain subgroups:
  - topology spread  → exact integer water-fill over eligible domains
    (equivalent to the reference's greedy "place each pod in the min-count
    domain", which never exceeds maxSkew>=1 — see _water_fill).
  - self anti-affinity → one pod per domain; surplus pods are
    unschedulable, like the reference when it runs out of domains.
  - self affinity → the whole group pins to one domain (the domain
    holding bound matches, else the first eligible one), mirroring the
    reference's first-pod-seeds-the-domain behavior.
  - cross-class zone anti-affinity → zones holding bound matching pods are
    masked out; pending-vs-pending overlap gets a warning (the sequential
    reference can interleave them; the batched form separates classes).

- **hostname scoped** constraints run IN-KERNEL, because hostname domains
  (bins) are created during the scan itself:
  - spread(maxSkew=s) → per-bin placement cap ``max_per_bin=s`` (while any
    eligible empty node exists, per-node counts in [0,s] keep skew<=s).
  - anti-affinity → per-bin affinity-class presence masks: the scan carries
    ``pm[B,A]`` ("bin holds a pod matching class a") and ``po[B,A]`` ("bin
    holds a pod owning anti-term a"); group g may enter bin b only if
    ``~any(pm[b]&owner[g]) & ~any(po[b]&match[g])`` — both directions of
    the k8s symmetry check.
  - affinity → ``need[g,a]`` requires ``pm[b,a]`` (join a seeded bin);
    self-affinity sets ``single_bin`` (all replicas co-locate on one node).

A = number of distinct affinity/spread label selectors ("classes"); G x A
and B x A stay tiny because selectors are deduplicated exactly like pod
groups are.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from ..apis import wellknown as wk
from ..apis.objects import Pod, PodAffinityTerm, TopologySpreadConstraint

_BIG = np.iinfo(np.int32).max


@dataclass(frozen=True)
class BoundPod:
    """An already-scheduled pod, for topology accounting: domain counts for
    spread, zone occupancy for zone anti-affinity, and per-existing-bin
    class presence for hostname terms (node_name links to ExistingBin.name)."""

    pod: Pod
    node_name: str
    zone: str
    capacity_type: str = wk.CAPACITY_TYPE_ON_DEMAND
    node_labels: Mapping[str, str] = field(default_factory=dict)  # custom-key spread domains


def _selector_key(sel: Tuple[Tuple[str, str], ...]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted(sel))


def _matches(sel: Tuple[Tuple[str, str], ...], labels: Mapping[str, str]) -> bool:
    return all(labels.get(k) == v for k, v in sel)


@dataclass
class ClassRegistry:
    """Deduplicated label selectors referenced by hostname-scoped terms."""

    keys: List[Tuple[Tuple[str, str], ...]] = field(default_factory=list)
    index: Dict[Tuple[Tuple[str, str], ...], int] = field(default_factory=dict)

    def intern(self, sel: Tuple[Tuple[str, str], ...]) -> int:
        k = _selector_key(sel)
        if k not in self.index:
            self.index[k] = len(self.keys)
            self.keys.append(k)
        return self.index[k]

    @property
    def A(self) -> int:
        return len(self.keys)

    def match_row(self, labels: Mapping[str, str]) -> np.ndarray:
        return np.array([_matches(sel, labels) for sel in self.keys], dtype=bool)


@dataclass
class GroupTopology:
    """Per-group-row topology attributes consumed by the kernel."""

    max_per_bin: int = _BIG
    spread_class: int = -1               # class whose per-bin count the cap tracks
    single_bin: bool = False
    match: Optional[np.ndarray] = None   # [A]
    owner: Optional[np.ndarray] = None   # [A]
    need: Optional[np.ndarray] = None    # [A]


def _water_fill(counts: np.ndarray, n: int) -> np.ndarray:
    """Distribute n units over domains with existing ``counts``, greedily to
    the min-count domain (exact integer water-fill). Returns additions per
    domain. Equivalent to the reference's per-pod min-domain placement: each
    step raises a current minimum, so resulting skew never exceeds
    max(initial_skew, 1) and spread stays maxSkew-feasible for maxSkew>=1."""
    counts = counts.astype(np.int64)
    k = len(counts)
    if k == 0 or n <= 0:
        return np.zeros((k,), dtype=np.int64)
    order = np.argsort(counts, kind="stable")
    sorted_c = counts[order]
    add = np.zeros((k,), dtype=np.int64)
    remaining = n
    # raise the lowest level up to the next level, domain by domain
    for i in range(k):
        level = sorted_c[i]
        width = i + 1
        nxt = sorted_c[i + 1] if i + 1 < k else None
        room = remaining if nxt is None else min(remaining, (nxt - level) * width)
        if room <= 0:
            continue
        base, extra = divmod(room, width)
        for j in range(width):
            add[order[j]] += base + (1 if j < extra else 0)
        sorted_c[: width] += base
        for j in range(int(extra)):
            sorted_c[j] += 1
        remaining -= room
        if remaining == 0:
            break
    if remaining > 0:  # all domains level: round-robin the tail
        base, extra = divmod(remaining, k)
        for j in range(k):
            add[order[j]] += base + (1 if j < extra else 0)
    return add


@dataclass
class _Split:
    """One output row: a slice of the group's pods with narrowed domain masks."""

    count: int
    zone_mask: np.ndarray
    cap_mask: np.ndarray
    # custom-key label values this slice pins (spread over user-defined
    # labels — the reference's 'virtual domains' ratio-split technique,
    # scheduling.md:558-614); build_problem routes the slice to pools
    # carrying/offering exactly these values
    custom: Dict[str, str] = field(default_factory=dict)


def resolve_group_topology(
    pod: Pod,
    count: int,
    zone_mask: np.ndarray,
    cap_mask: np.ndarray,
    zones: Sequence[str],
    capacity_types: Sequence[str],
    registry: ClassRegistry,
    bound: Sequence[BoundPod],
    warnings: List[str],
    pending_counts: Optional[Dict] = None,
    custom_domains: Optional[Mapping[str, Sequence[str]]] = None,
) -> Tuple[List[_Split], GroupTopology, int]:
    """Resolve one pod group's topology constraints.

    Returns (splits, per-row topology attributes, pods_cut) where pods_cut
    is the number of pods made unschedulable by domain exhaustion (zone
    self-anti-affinity with more replicas than eligible zones).

    ``pending_counts`` maps (selector, topology_key) → per-domain additions
    already planned for earlier groups in this batch, so sibling groups
    sharing a spread selector fill against the COMBINED counts (the skew
    bound is per selector, not per group; the kernel's pm counters do the
    same for hostname).
    """
    topo = GroupTopology()
    zmask = zone_mask.copy()
    cmask = cap_mask.copy()
    cut = 0
    zone_index = {z: i for i, z in enumerate(zones)}
    cap_index = {c: i for i, c in enumerate(capacity_types)}

    # ---- pod (anti-)affinity --------------------------------------------
    match_row = None
    owner = np.zeros((0,), dtype=bool)
    need = np.zeros((0,), dtype=bool)
    for term in pod.pod_affinity:
        sel = tuple(term.label_selector)
        self_match = _matches(sel, pod.labels)
        if term.topology_key == wk.LABEL_HOSTNAME:
            a = registry.intern(sel)
            if a >= len(owner):
                pad = a + 1 - len(owner)
                owner = np.concatenate([owner, np.zeros((pad,), dtype=bool)])
                need = np.concatenate([need, np.zeros((pad,), dtype=bool)])
            if term.anti:
                owner[a] = True
                if self_match:
                    topo.max_per_bin = min(topo.max_per_bin, 1)
            else:
                if self_match:
                    topo.single_bin = True
                else:
                    need[a] = True
        elif term.topology_key == wk.LABEL_ZONE:
            if term.anti:
                # zones already holding matching pods are off-limits
                for bp in bound:
                    if _matches(sel, bp.pod.labels) and bp.zone in zone_index:
                        zmask[zone_index[bp.zone]] = False
                # and symmetric: bound pods owning zone-anti terms against us
                if not self_match:
                    warnings.append(
                        "zone-scoped podAntiAffinity between distinct pending classes is "
                        "resolved against bound pods only; pending-vs-pending interleave "
                        "is not separated in one batch")
            else:
                # co-locate in one zone: prefer a zone with bound matches
                target = None
                for bp in bound:
                    if _matches(sel, bp.pod.labels) and bp.zone in zone_index and zmask[zone_index[bp.zone]]:
                        target = zone_index[bp.zone]
                        break
                if target is None:
                    elig = np.nonzero(zmask)[0]
                    target = int(elig[0]) if elig.size else None
                    if not self_match:
                        warnings.append(
                            "zone-scoped podAffinity to a class with no bound pods pins "
                            "to an arbitrary eligible zone; the pending target class is "
                            "not co-anchored in one batch")
                if target is not None:
                    pin = np.zeros_like(zmask)
                    pin[target] = True
                    zmask = pin
        else:
            warnings.append(f"pod (anti-)affinity on topology key {term.topology_key!r} is not supported")

    # symmetric direction: bound pods owning hostname anti-terms that match us
    # are accounted via po-seeding of existing bins (build_problem).

    # ---- zone self-anti: one replica per eligible zone ------------------
    zone_self_anti = any(
        term.anti and term.topology_key == wk.LABEL_ZONE
        and _matches(tuple(term.label_selector), pod.labels)
        for term in pod.pod_affinity)

    # ---- topology spread ------------------------------------------------
    zone_spread: Optional[TopologySpreadConstraint] = None
    cap_spread: Optional[TopologySpreadConstraint] = None
    custom_spreads: List[TopologySpreadConstraint] = []
    for c in pod.topology_spread:
        if c.topology_key == wk.LABEL_ZONE:
            if zone_spread is not None:
                warnings.append("multiple zone topologySpreadConstraints on one pod; first wins")
            else:
                zone_spread = c
        elif c.topology_key == wk.LABEL_HOSTNAME:
            # the kernel tracks the per-bin count of this selector's class so
            # bound pods and sibling groups with the same labels are counted
            a = registry.intern(tuple(c.label_selector))
            if topo.spread_class >= 0 and topo.spread_class != a:
                warnings.append("multiple hostname topologySpreadConstraints with "
                                "distinct selectors on one pod; first selector wins")
            else:
                topo.spread_class = a
            topo.max_per_bin = min(topo.max_per_bin, max(1, c.max_skew))
        elif c.topology_key == wk.LABEL_CAPACITY_TYPE:
            if cap_spread is not None:
                warnings.append("multiple capacity-type topologySpreadConstraints; first wins")
            else:
                cap_spread = c
        elif c.when_unsatisfiable == "ScheduleAnyway":
            # advisory skew on a custom key: never a split/unschedulable
            # cause (matches the zone/captype ScheduleAnyway treatment)
            pass
        elif custom_domains is not None and custom_domains.get(c.topology_key):
            custom_spreads.append(c)
        else:
            warnings.append(
                f"topologySpreadConstraint on key {c.topology_key!r} has no "
                f"discoverable domains (no NodePool offers the key, no node "
                f"carries it)")

    # finalize class rows at full registry width later (build_problem pads);
    # here record the sparse rows
    topo.owner = owner
    topo.need = need
    topo.match = None  # filled by build_problem once the registry is final

    # ---- build splits ---------------------------------------------------
    splits: List[_Split] = []

    def spread_counts(sel: Tuple[Tuple[str, str], ...], key: str) -> np.ndarray:
        """Matching-pod counts per domain: bound pods + additions already
        planned for earlier sibling groups in this batch."""
        if key == wk.LABEL_ZONE:
            out = np.zeros((len(zones),), dtype=np.int64)
            for bp in bound:
                if _matches(sel, bp.pod.labels) and bp.zone in zone_index:
                    out[zone_index[bp.zone]] += 1
        else:
            out = np.zeros((len(capacity_types),), dtype=np.int64)
            for bp in bound:
                if _matches(sel, bp.pod.labels) and bp.capacity_type in cap_index:
                    out[cap_index[bp.capacity_type]] += 1
        if pending_counts is not None:
            prior = pending_counts.get((_selector_key(sel), key))
            if prior is not None:
                out = out + prior
        return out

    def record_adds(sel: Tuple[Tuple[str, str], ...], key: str,
                    domain_indices, adds) -> None:
        if pending_counts is None:
            return
        k = (_selector_key(sel), key)
        size = len(zones) if key == wk.LABEL_ZONE else len(capacity_types)
        acc = pending_counts.setdefault(k, np.zeros((size,), dtype=np.int64))
        for di, n in zip(domain_indices, adds):
            acc[di] += int(n)

    if zone_self_anti:
        elig = np.nonzero(zmask)[0]
        # zones already holding a match were masked above; one new pod per zone
        for zi in elig[: count]:
            m = np.zeros_like(zmask)
            m[zi] = True
            splits.append(_Split(1, m, cmask.copy()))
        cut = max(0, count - elig.size)
    elif zone_spread is not None:
        elig = np.nonzero(zmask)[0]
        if elig.size == 0:
            splits.append(_Split(count, zmask, cmask))
        else:
            sel = tuple(zone_spread.label_selector)
            existing = spread_counts(sel, wk.LABEL_ZONE)[elig]
            adds = _water_fill(existing, count)
            if _matches(sel, pod.labels):
                record_adds(sel, wk.LABEL_ZONE, elig, adds)
            for zi, n in zip(elig, adds):
                if n <= 0:
                    continue
                m = np.zeros_like(zmask)
                m[zi] = True
                splits.append(_Split(int(n), m, cmask.copy()))
    else:
        splits.append(_Split(count, zmask, cmask))

    if cap_spread is not None:
        out: List[_Split] = []
        # the skew constraint is global across all zone splits: fold each
        # split's additions into the running domain counts so later splits
        # keep topping up the lowest capacity type
        sel = tuple(cap_spread.label_selector)
        running = spread_counts(sel, wk.LABEL_CAPACITY_TYPE)
        for s in splits:
            elig = np.nonzero(s.cap_mask)[0]
            if elig.size == 0:
                out.append(s)
                continue
            adds = _water_fill(running[elig], s.count)
            running[elig] += adds
            if _matches(sel, pod.labels):
                record_adds(sel, wk.LABEL_CAPACITY_TYPE, elig, adds)
            for ci, n in zip(elig, adds):
                if n <= 0:
                    continue
                m = np.zeros_like(s.cap_mask)
                m[ci] = True
                out.append(_Split(int(n), s.zone_mask.copy(), m,
                                  custom=dict(s.custom)))
        splits = out

    # ---- custom-key spread: the 'virtual domains' split -----------------
    # (reference scheduling.md:558-614: spreading across a user-defined
    # label whose values come from NodePool requirements — e.g. the
    # capacity-spread on-demand/spot ratio technique). Domains are
    # discovered by build_problem; counting works exactly like
    # zone/captype: existing matching pods per node-label value + pending
    # sibling additions, then exact water-fill.
    for c in custom_spreads:
        key = c.topology_key
        # counts and pending records index the CANONICAL domain list (the
        # full discovered set) so sibling groups with different per-group
        # eligibility still accumulate into the same axis
        domains = list(custom_domains[key])
        own = pod.hard_scheduling_requirements()
        elig = np.array([key not in set(own.keys()) or own.get(key).matches(d)
                         for d in domains], dtype=bool)
        if not elig.any():
            continue
        sel = tuple(c.label_selector)
        running = np.zeros((len(domains),), dtype=np.int64)
        dom_index = {d: i for i, d in enumerate(domains)}
        for bp in bound:
            if _matches(sel, bp.pod.labels):
                di = dom_index.get(bp.node_labels.get(key))
                if di is not None:
                    running[di] += 1
        pk = (_selector_key(sel), key)
        prior = None
        if pending_counts is not None:
            prior = pending_counts.get(pk)
            if prior is not None and len(prior) == len(domains):
                running = running + prior
            else:
                prior = None
        adds_total = np.zeros((len(domains),), dtype=np.int64)
        elig_idx = np.nonzero(elig)[0]
        out2: List[_Split] = []
        for s in splits:
            adds = _water_fill(running[elig_idx], s.count)
            running[elig_idx] += adds
            adds_total[elig_idx] += adds
            for di, n in zip(elig_idx, adds):
                if n <= 0:
                    continue
                out2.append(_Split(int(n), s.zone_mask.copy(),
                                   s.cap_mask.copy(),
                                   custom={**s.custom, key: domains[di]}))
        if pending_counts is not None and _matches(sel, pod.labels):
            # record ADDS only (bound pods recount for every group)
            pending_counts[pk] = (prior if prior is not None
                                  else np.zeros((len(domains),), np.int64)) + adds_total
        splits = out2

    return splits, topo, cut
