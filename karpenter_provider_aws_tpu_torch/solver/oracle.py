"""Host-side First-Fit-Decreasing oracle.

A faithful, per-pod sequential reimplementation of the reference's scheduling
algorithm (reference designs/bin-packing.md:16-43: sort pods by size
descending; first-fit into existing simulated nodes; else open a new node
from the highest-weight compatible NodePool; finally price each node at its
cheapest compatible offering), including the hostname-scoped topology rules
the kernel enforces (per-bin caps, affinity-class presence; zone/captype
scoped rules are already resolved into the Problem's group rows). Pure
Python/numpy, deliberately simple — the regression referee for the device
kernel's pack quality (the ≤2% cost envelope in BASELINE.md) and the
semantics oracle for parity tests.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import taxonomy
from .explain import unplaced_reason
from .problem import Problem


@dataclass
class OracleBin:
    np_idx: int
    cum: np.ndarray            # [R]
    tmask: np.ndarray          # [T] feasible types so far
    zmask: np.ndarray          # [Z]
    cmask: np.ndarray          # [C]
    pods: List[str] = field(default_factory=list)
    group_counts: Dict[int, int] = field(default_factory=dict)
    pm: np.ndarray = None      # [A] i32 count of pods matching each class
    po: np.ndarray = None      # [A] anti-term owners present
    existing_idx: Optional[int] = None   # fixed bin: index into problem.existing

    @property
    def is_existing(self) -> bool:
        return self.existing_idx is not None


@dataclass
class OraclePlan:
    bins: List[OracleBin]
    new_node_cost: float                       # $/hr of newly created nodes
    chosen: List[Tuple[int, int, int]]         # per new bin: (type, zone, cap) indices
    unschedulable: Dict[str, str]

    @property
    def num_new_nodes(self) -> int:
        return sum(1 for b in self.bins if not b.is_existing and b.pods)


def ffd_oracle(problem: Problem) -> OraclePlan:
    lat = problem.lattice
    alloc, avail, price = lat.alloc, lat.available, lat.price
    # per-pool allocatable ceiling (kubelet maxPods): a new bin of pool
    # pi fits against min(lattice alloc, pool cap) exactly like the kernel
    eff_alloc = np.minimum(alloc[None, :, :],
                           problem.np_alloc_cap[:, None, :])  # [NP,T,R]
    unschedulable = dict(problem.unschedulable)
    A = problem.A

    bins: List[OracleBin] = []
    for ei in range(problem.E):
        ti = int(problem.e_type[ei])
        tmask = np.zeros((lat.T,), dtype=bool)
        tmask[ti] = True
        zmask = np.zeros((lat.Z,), dtype=bool)
        zmask[int(problem.e_zone[ei])] = True
        cmask = np.zeros((lat.C,), dtype=bool)
        cmask[int(problem.e_cap[ei])] = True
        bins.append(OracleBin(np_idx=int(problem.e_np[ei]), cum=problem.e_used[ei].copy(),
                              tmask=tmask, zmask=zmask, cmask=cmask,
                              pm=problem.e_pm[ei].copy() if A else np.zeros((0,), np.int32),
                              po=problem.e_po[ei].copy() if A else np.zeros((0,), bool),
                              existing_idx=ei))

    def type_has_offering(tm: np.ndarray, zm: np.ndarray, cm: np.ndarray) -> np.ndarray:
        """[T] bool: type compatible AND has an available offering in zm x cm."""
        return tm & (avail & zm[None, :, None] & cm[None, None, :]).any(axis=(1, 2))

    single_bin_home: Dict[int, int] = {}  # group idx -> bin idx for single_bin groups

    # groups are already FFD-sorted; expand each group pod by pod.
    # A group's pods are identical, and a bin changes only when a pod is
    # placed into it, so a bin that rejected one pod of the group rejects
    # every later one: each pod's first-fit scan starts at the bin that
    # took the previous pod (``start``). Same plan as scanning from bin 0,
    # in O(pods + groups x bins) bin checks instead of O(pods x bins).
    for gi, group in enumerate(problem.groups):
        cap = int(problem.max_per_bin[gi])
        start = 0
        for pod_name in group.pod_names:
            req = group.req
            placed = False
            for bi in range(start, len(bins)):
                b = bins[bi]
                if group.single_bin and gi in single_bin_home and single_bin_home[gi] != bi:
                    continue
                if b.np_idx >= 0:
                    if not group.np_ok[b.np_idx]:
                        continue
                elif not b.is_existing:
                    continue
                elif group.strict_custom:
                    # unknown-pool node: cannot verify custom-label selectors
                    continue
                # per-bin cap: hostname spread tracks the whole class's
                # count (bound + sibling groups, same as the kernel's pm);
                # class-less caps (self-anti) count this row's placements
                if group.spread_class >= 0:
                    if b.pm[group.spread_class] >= cap:
                        continue
                elif b.group_counts.get(gi, 0) >= cap:
                    continue
                if A:
                    # k8s symmetry (same test as the kernel): bin holds no pod
                    # we anti-affine against, no pod anti-affining against us,
                    # and every class we need is present
                    if ((b.pm > 0) & group.owner).any() or (b.po & group.match).any():
                        continue
                    if not np.all((b.pm > 0) | ~group.need):
                        continue
                if b.is_existing:
                    # fixed node: capacity check against its own allocatable
                    new_cum = b.cum + req
                    ei = b.existing_idx
                    if (new_cum <= problem.e_alloc[ei] + 1e-3).all() and group.type_mask[int(problem.e_type[ei])] \
                            and group.zone_mask[int(problem.e_zone[ei])] and group.cap_mask[int(problem.e_cap[ei])]:
                        b.cum = new_cum
                        b.pods.append(pod_name)
                        b.group_counts[gi] = b.group_counts.get(gi, 0) + 1
                        if A:
                            b.pm += group.match.astype(np.int32)
                            b.po |= group.owner
                        if group.single_bin:
                            single_bin_home[gi] = bi
                        placed = True
                        start = bi
                        break
                    continue
                tm = b.tmask & group.type_mask
                zm = b.zmask & group.zone_mask
                cm = b.cmask & group.cap_mask
                new_cum = b.cum + req
                fits = tm & (eff_alloc[b.np_idx] >= new_cum[None, :] - 1e-3).all(axis=1)
                fits = type_has_offering(fits, zm, cm)
                if fits.any():
                    b.cum, b.tmask, b.zmask, b.cmask = new_cum, fits, zm, cm
                    b.pods.append(pod_name)
                    b.group_counts[gi] = b.group_counts.get(gi, 0) + 1
                    if A:
                        b.pm += group.match.astype(np.int32)
                        b.po |= group.owner
                    if group.single_bin:
                        single_bin_home[gi] = bi
                    placed = True
                    start = bi
                    break
            if placed:
                continue
            # every bin rejected this pod; a new bin (if one opens below)
            # is the only candidate left for the next pod
            start = len(bins)
            # distinct taxonomy codes per cause (solver/taxonomy.py):
            # the single generic string hid three different triages
            if group.single_bin and gi in single_bin_home:
                unschedulable[pod_name] = taxonomy.reason(
                    taxonomy.SINGLE_BIN_FULL,
                    "hostname self-affinity pins the group to one node "
                    "and it cannot hold more pods")
                continue
            # a fresh bin satisfies presence needs only by self-seeding
            if A and not np.all(group.match | ~group.need):
                unschedulable[pod_name] = taxonomy.reason(
                    taxonomy.AFFINITY_PRESENCE,
                    "required affinity class present on no node and the "
                    "group cannot self-seed it")
                continue
            # open a new node: highest-weight compatible pool with a feasible type
            for pi in np.nonzero(group.np_ok)[0]:
                pi = int(pi)
                cum = problem.ds_overhead[pi] + req
                tm = group.type_mask & problem.np_type[pi]
                zm = group.zone_mask & problem.np_zone[pi]
                cm = group.cap_mask & problem.np_cap[pi]
                fits = tm & (eff_alloc[pi] >= cum[None, :] - 1e-3).all(axis=1)
                fits = type_has_offering(fits, zm, cm)
                if fits.any():
                    nb = OracleBin(np_idx=pi, cum=cum, tmask=fits, zmask=zm, cmask=cm,
                                   pods=[pod_name], group_counts={gi: 1},
                                   pm=group.match.astype(np.int32) if A else np.zeros((0,), np.int32),
                                   po=group.owner.copy() if A else np.zeros((0,), bool))
                    bins.append(nb)
                    if group.single_bin:
                        single_bin_home[gi] = len(bins) - 1
                    placed = True
                    break
            if not placed:
                # no-existing-fit: no compatible pool can open a node at
                # all, so only existing capacity could have hosted it;
                # no-new-node-shape: pools exist but no empty node of any
                # feasible type holds the pod. The group's ledger refines
                # further (an ICE-zeroed group reads ice-hold).
                unschedulable[pod_name] = unplaced_reason(
                    group,
                    fallback=(taxonomy.NO_EXISTING_FIT
                              if not group.np_ok.any()
                              else taxonomy.NO_NEW_NODE_SHAPE))

    # finalize: cheapest available offering per new bin
    cost = 0.0
    chosen: List[Tuple[int, int, int]] = []
    for b in bins:
        if b.is_existing or not b.pods:
            continue
        p = np.where(avail & b.tmask[:, None, None] & b.zmask[None, :, None] & b.cmask[None, None, :],
                     price, np.inf)
        t, z, c = np.unravel_index(int(np.argmin(p)), p.shape)
        assert np.isfinite(p[t, z, c]), "oracle invariant: open bin must have an offering"
        chosen.append((int(t), int(z), int(c)))
        cost += float(p[t, z, c])
    return OraclePlan(bins=bins, new_node_cost=cost, chosen=chosen, unschedulable=unschedulable)
