"""Revision-keyed incremental problem build for steady-state reconciles.

The port of the JAX package's ``solver/incremental.py`` (it has no device
code; this copy exists so the port imports nothing of the JAX package).
A steady-state provisioning pass re-solves a problem in which few pods
changed since the last one; rebuilding and re-tensorizing the whole
problem every pass is the host's largest share of such a pass. The
:class:`IncrementalProblemBuilder` retains the previous
:class:`~.problem.Problem` keyed by the cluster state revision (a
state/cluster.py ``DirtySet``) and, when the pass's churn is local,
produces the next problem by patching ONLY what moved:

- journal-touched pods are matched to the previous build's signature
  groups (the same interned signatures build_problem groups with) and
  their groups' membership lists/counts updated in copy-on-write form;
- the existing-bin arrays are re-derived from the current bin list (an
  O(E) numpy pass — bins are hundreds where pods are tens of thousands);
- every retained group's count-dependent narrowing decision is replayed
  against the content-cached candidate tables
  (solver/problem.py recheck_narrow) — a flipped decision aborts to a
  full rebuild, so the incremental problem is always plan-equivalent to
  a from-scratch build.

Everything else — one gate failing, a new scheduling signature, topology
/affinity/volume machinery in play, pool or lattice or daemonset drift —
falls back to :func:`~.problem.build_problem`, the always-correct path.
The builder never guesses: any doubt → rebuild.

The caller hands the resulting problem to ``Solver.solve_delta``
(solver/solve.py), whose microloop keeps the whole fused problem
resident on the card: the patched build here becomes one dirty-block
scatter, and the plan comes back only when an on-device fingerprint
says it moved.

As in the JAX package, ``explain`` defaults to True: every full build
captures constraint-elimination ledgers (solver/explain.py), and the
delta path patches a group's ledger copy-on-write (``with_count``).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from ..apis.objects import NodePool, Pod
from ..lattice.tensors import Lattice
from .problem import (Problem, _BIG, build_problem, recheck_narrow,
                      signature_of)

# an incremental pass touching more than this fraction of the previous
# build's pods rebuilds instead: the per-pod patch path's constant
# factors beat the vectorized full build only while churn is local
_MAX_CHURN_FRACTION = 0.25


@dataclass
class BuildResult:
    problem: Problem
    incremental: bool = False
    dirty_groups: Tuple[int, ...] = ()
    reason: str = ""            # why a full rebuild ran ("" = incremental)
    rev: int = -1               # cluster-state revision this build is keyed at
    journal_ticks: int = 1      # coalesced journal drains behind this build
                                # (>1 = the controller fell behind and the
                                # coalescer batched ticks into one delta)


def _resolve(x):
    """Inputs may arrive as values or as zero-arg thunks; thunks let the
    provisioner skip O(pods) cluster scans (existing_bins, bound_pods)
    entirely on passes where the journal proves they did not change."""
    return x() if callable(x) else x


def _pool_fingerprint(pools: Sequence[NodePool]) -> tuple:
    """Cheap content fingerprint of everything about a NodePool that
    feeds build_problem (masks, taints/tolerations, weight order,
    kubelet clamp, virtual-pool expansion inputs). Pools are few; this
    is microseconds."""
    out = []
    for p in pools:
        out.append((
            p.name, p.weight, p.node_class_ref,
            tuple(sorted(p.labels.items())),
            tuple(sorted((t.key, t.value or "", t.effect)
                         for t in p.taints)),
            tuple(sorted((r.key, r.operator.value,
                          tuple(sorted(str(v) for v in r.values)))
                         for r in p.requirements)),
            (p.kubelet.max_pods if p.kubelet is not None else None),
        ))
    return tuple(sorted(out))


def _headroom_fingerprint(h: Optional[Mapping[str, np.ndarray]]):
    if not h:
        return None
    return {k: v.tobytes() for k, v in h.items()}


class IncrementalProblemBuilder:
    """Stateful wrapper over build_problem with a delta fast path.

    Thread-compat: ONE owner (the provisioner serializes passes); the
    builder itself keeps no locks.
    """

    def __init__(self, explain: bool = True):
        # capture constraint-elimination ledgers on every full build
        # (solver/explain.py); the delta path patches them copy-on-write
        self._explain = explain
        self._prev: Optional[Problem] = None
        self._rev: int = -1
        self._lattice: Optional[Lattice] = None
        self._price_version: int = -1
        self._pool_fp: Optional[tuple] = None
        self._headroom_fp = None
        self._simple = False        # prev build eligible for deltas at all
        self._sig_to_gi: Dict[str, int] = {}
        self._pod_to_gi: Optional[Dict[str, int]] = None   # lazy
        self._dropped_pods: frozenset = frozenset()
        self._bin_types: frozenset = frozenset()
        # observability (Solver.stats folds the solve-side counters; the
        # provisioner provider folds these)
        self.incremental_builds = 0
        self.full_builds = 0
        self.last_reason = ""

    @property
    def rev(self) -> int:
        """The cluster-state revision of the retained build (-1 = cold);
        the provisioner reads the dirty journal from here."""
        return self._rev

    # ---- stats ----------------------------------------------------------

    def stats(self) -> Dict[str, object]:
        return {
            "incremental_builds": self.incremental_builds,
            "full_builds": self.full_builds,
            "eligible": self._simple,
        }

    # ---- the entry point ------------------------------------------------

    def build(self, pods: Sequence[Pod], node_pools: Sequence[NodePool],
              lattice: Lattice, existing=(), daemonset_pods=(),
              bound_pods=(), pvcs=None, storage_classes=None,
              pool_headroom=None, dirty=None,
              touched: Optional[Mapping[str, Tuple[str, Optional[Pod]]]]
              = None) -> BuildResult:
        """Build the problem for ``pods``, incrementally when the dirty
        set allows. ``existing``/``daemonset_pods``/``bound_pods``/
        ``pvcs``/``storage_classes`` may be values or zero-arg thunks
        (resolved only when actually needed). ``dirty`` is a
        state/cluster.py DirtySet; ``touched`` maps each dirty pod name
        to its (state, pod) classification (ClusterState.touched_pods).
        """
        ticks = dirty.ticks if dirty is not None else 1
        reason = self._delta_blocker(pods, node_pools, lattice,
                                     pool_headroom, dirty, touched)
        if reason is None:
            res = self._build_delta(pods, lattice, existing, dirty, touched)
            if res is not None:
                self.incremental_builds += 1
                self.last_reason = ""
                res.journal_ticks = ticks
                return res
            reason = self.last_reason or "delta-failed"
        res = self._build_full(pods, node_pools, lattice, existing,
                               daemonset_pods, bound_pods, pvcs,
                               storage_classes, pool_headroom, dirty,
                               reason)
        res.journal_ticks = ticks
        return res

    # ---- gates ----------------------------------------------------------

    def _delta_blocker(self, pods, node_pools, lattice, pool_headroom,
                       dirty, touched) -> Optional[str]:
        """The any-doubt-→-rebuild gate ladder. Returns the blocking
        reason, or None when the delta path may run."""
        if dirty is None:
            return "no-dirty-set"
        if self._prev is None:
            return "cold"
        if dirty.full or dirty.other:
            return "journal-overflow" if dirty.full else "untracked-mutation"
        if dirty.since != self._rev:
            return "revision-skew"
        if not self._simple:
            return self.last_reason or "complex-problem"
        if dirty.volumes:
            return "volume-churn"
        if dirty.daemonsets:
            return "daemonset-churn"
        if lattice is not self._lattice:
            return "lattice-changed"
        if lattice.price_version != self._price_version:
            return "price-changed"
        if touched is None and dirty.pods:
            return "no-touched-classification"
        if len(dirty.pods) > max(64, int(
                _MAX_CHURN_FRACTION * max(len(pods), 1))):
            return "bulk-churn"
        if _pool_fingerprint(node_pools) != self._pool_fp:
            return "pools-changed"
        hfp = _headroom_fingerprint(_resolve(pool_headroom))
        if hfp != self._headroom_fp:
            return "headroom-changed"
        return None

    @staticmethod
    def _eligibility(problem: Problem, pods: Sequence[Pod],
                     bound_pods: Sequence) -> str:
        """Why this build can NOT seed deltas ("" = it can). The simple
        shape the delta path supports: one group per signature, no
        affinity classes / topology splits / virtual pools / volume zone
        pins / relaxable soft constraints — the steady-state common case."""
        from .problem import _selector_keys
        if _selector_keys(pods, bound_pods):
            # ANY selector key in play (a bound pod's spread/affinity
            # counts even when no class compiled) changes how labels
            # project into signatures — signature_of's churned-pod
            # matching assumes the empty projection
            return "selector-keys"
        if problem.A:
            return "affinity-classes"
        if any(p.custom_labels for p in problem.node_pools):
            return "virtual-pools"
        if problem.G:
            if problem.single_bin.any():
                return "single-bin-groups"
            if (problem.g_spread != -1).any():
                return "spread-classes"
            if (problem.max_per_bin < _BIG).any():
                return "per-bin-caps"
            if problem.strict_custom.any():
                return "strict-custom-keys"
        # one O(pods) scan, paid ONCE per full build: anything with
        # selector/topology machinery, volumes, or relaxable soft
        # constraints takes the always-correct full path
        for p in pods:
            d = p.__dict__
            if (d.get("pod_affinity") or d.get("topology_spread")
                    or d.get("preferred_affinity")
                    or d.get("volume_claims")):
                return "complex-pods"
        return ""

    # ---- full build ------------------------------------------------------

    def _build_full(self, pods, node_pools, lattice, existing,
                    daemonset_pods, bound_pods, pvcs, storage_classes,
                    pool_headroom, dirty, reason) -> BuildResult:
        existing = _resolve(existing) or ()
        headroom = _resolve(pool_headroom)
        bound = _resolve(bound_pods) or ()
        problem = build_problem(
            pods, node_pools, lattice, existing=existing,
            daemonset_pods=_resolve(daemonset_pods) or (),
            bound_pods=bound,
            pvcs=_resolve(pvcs), storage_classes=_resolve(storage_classes),
            pool_headroom=headroom, explain=self._explain)
        self.full_builds += 1
        self.last_reason = reason
        self._prev = problem
        self._rev = dirty.rev if dirty is not None else -1
        self._lattice = lattice
        self._price_version = lattice.price_version
        self._pool_fp = _pool_fingerprint(node_pools)
        self._headroom_fp = _headroom_fingerprint(headroom)
        self._pod_to_gi = None   # rebuilt lazily on the first delta
        self._dropped_pods = frozenset(
            n for g in problem.dropped_groups for n in g.pod_names)
        self._bin_types = frozenset(b.instance_type for b in existing)
        blocker = self._eligibility(problem, pods, bound)
        # a signature appearing in TWO groups (topology split slipped the
        # gates) would make pod→group matching ambiguous
        self._sig_to_gi = {}
        for gi, g in enumerate(problem.groups):
            if not blocker and g.signature in self._sig_to_gi:
                blocker = "split-signature"
            self._sig_to_gi[g.signature] = gi
        self._simple = not blocker
        self.last_reason = blocker or reason
        return BuildResult(problem=problem, incremental=False,
                           reason=reason, rev=self._rev)

    # ---- the delta path --------------------------------------------------

    def _pod_map(self) -> Dict[str, int]:
        """pod name -> group index of the previous build (lazy: one
        O(pods) dict build per FULL build, amortized across every delta
        that follows it)."""
        if self._pod_to_gi is None:
            m: Dict[str, int] = {}
            for gi, g in enumerate(self._prev.groups):
                for n in g.pod_names:
                    m[n] = gi
            self._pod_to_gi = m
        return self._pod_to_gi

    def _build_delta(self, pods, lattice, existing, dirty,
                     touched) -> Optional[BuildResult]:
        prev = self._prev
        pod_map = self._pod_map()
        unschedulable = None     # copy-on-write
        new_names: Dict[int, List[str]] = {}
        dirty_gis: set = set()

        def names_of(gi: int) -> List[str]:
            lst = new_names.get(gi)
            if lst is None:
                lst = list(prev.groups[gi].pod_names)
                new_names[gi] = lst
                dirty_gis.add(gi)
            return lst

        removed: Dict[int, set] = {}
        adds: List[Tuple[str, Pod]] = []
        for name in (dirty.pods if dirty is not None else ()):
            if name in self._dropped_pods:
                # a build-time-dropped group's membership changed: the
                # retained dropped_groups (and their ledgers) would go
                # stale and explain differently from a full rebuild —
                # parity over speed, always
                self.last_reason = "dropped-group-churn"
                return None
            state, pod = (touched.get(name, ("gone", None))
                          if touched is not None else ("gone", None))
            gi = pod_map.get(name)
            if gi is not None:
                removed.setdefault(gi, set()).add(name)
                del pod_map[name]
            if unschedulable is None and name in prev.unschedulable:
                unschedulable = dict(prev.unschedulable)
            if unschedulable is not None:
                unschedulable.pop(name, None)
            if state == "daemonset":
                self.last_reason = "daemonset-churn"
                return None
            if pod is not None:
                d = pod.__dict__
                if (d.get("pod_affinity") or d.get("topology_spread")
                        or d.get("volume_claims")):
                    # a touched pod with selector/volume machinery in ANY
                    # state changes semantics the retained build never
                    # compiled — a pod first seen BOUND with anti-affinity
                    # must repel matching pending pods (the k8s symmetry
                    # rule), which only a full rebuild's bound-pod class
                    # compilation can express
                    self.last_reason = "complex-pod-churn"
                    return None
            if state == "pending":
                adds.append((name, pod))

        # apply removals group-by-group (one list rebuild per dirty group)
        for gi, gone in removed.items():
            lst = names_of(gi)
            new_names[gi] = [n for n in lst if n not in gone]

        # re-add pending pods by signature; an unknown signature means a
        # shape this build has never compiled → full rebuild
        for name, pod in adds:
            sig, bad = signature_of(pod)
            if bad is not None:
                if unschedulable is None:
                    unschedulable = dict(prev.unschedulable)
                unschedulable[name] = bad
                continue
            gi = self._sig_to_gi.get(sig)
            if gi is None:
                self.last_reason = "new-signature"
                return None
            names_of(gi).append(name)
            pod_map[name] = gi

        count = prev.count
        if dirty_gis:
            count = prev.count.copy()
            for gi in dirty_gis:
                count[gi] = len(new_names[gi])
        total = int(count.sum())
        unsched = (unschedulable if unschedulable is not None
                   else prev.unschedulable)
        if total + len(unsched) != len(pods):
            # the journal and the pending snapshot disagree (a race in
            # the threaded stratum, or an untracked path) — never ship a
            # problem that doesn't cover exactly the pending set
            self.last_reason = "count-mismatch"
            return None

        # replay every retained group's count-dependent narrowing against
        # the cached candidate tables; one flipped decision → rebuild.
        # total_pending replays as len(pods) — exactly what a from-scratch
        # build_problem passes (unschedulable pods included), which the
        # count guard above just proved consistent
        for gi, g in enumerate(prev.groups):
            if not recheck_narrow(g, int(count[gi]), len(pods), lattice):
                self.last_reason = "narrow-flip"
                return None

        # existing bins: re-derive the arrays only when the journal says
        # they moved; the bin TYPE set changing affects narrowing and
        # feasibility of retained groups → rebuild
        if dirty is not None and dirty.bins:
            existing = list(_resolve(existing) or ())
            if (len(existing) > 0) != (prev.E > 0):
                self.last_reason = "bin-presence-flip"
                return None
            if frozenset(b.instance_type for b in existing) != self._bin_types:
                self.last_reason = "bin-types-changed"
                return None
            e_arrays = self._existing_arrays(existing, lattice, prev)
        else:
            existing = prev.existing
            e_arrays = None

        groups = prev.groups
        if dirty_gis:
            groups = list(prev.groups)
            for gi in dirty_gis:
                g = replace(prev.groups[gi], pod_names=new_names[gi])
                g._narrow_ctx = getattr(prev.groups[gi], "_narrow_ctx", None)
                if g.ledger is not None:
                    # ledger copy-on-write: the stage counts are count-
                    # independent (recheck_narrow above proved the one
                    # count-dependent decision unchanged), so only the
                    # pods field moves — a delta-built pass explains
                    # identically to a full rebuild (parity-pinned)
                    g.ledger = g.ledger.with_count(len(new_names[gi]))
                groups[gi] = g
        problem = replace(
            prev, groups=groups, count=count,
            existing=list(existing),
            unschedulable=(unschedulable if unschedulable is not None
                           else dict(prev.unschedulable)),
            **(e_arrays or {}))

        self._prev = problem
        self._rev = dirty.rev
        self._sig_to_gi = {g.signature: gi for gi, g in enumerate(groups)} \
            if dirty_gis else self._sig_to_gi
        return BuildResult(problem=problem, incremental=True,
                           dirty_groups=tuple(sorted(dirty_gis)),
                           rev=self._rev)

    @staticmethod
    def _existing_arrays(existing, lattice: Lattice,
                         prev: Problem) -> Dict[str, np.ndarray]:
        """The existing-bin tail of build_problem for the simple shape
        (no affinity classes, no virtual pools): an O(E) pass over
        hundreds of bins where the full build re-scans tens of thousands
        of pods."""
        E = len(existing)
        from ..apis.resources import R
        e_used = np.zeros((E, R), np.float32)
        e_alloc = np.zeros((E, R), np.float32)
        e_type = np.zeros((E,), np.int32)
        e_zone = np.zeros((E,), np.int32)
        e_cap = np.zeros((E,), np.int32)
        e_np = np.full((E,), -1, np.int32)
        pool_index = {p.name: i for i, p in enumerate(prev.node_pools)}
        zone_index = {z: i for i, z in enumerate(lattice.zones)}
        cap_index = {c: i for i, c in enumerate(lattice.capacity_types)}
        for ei, b in enumerate(existing):
            ti = lattice.name_to_idx[b.instance_type]
            e_used[ei] = b.used
            if b.alloc_override is not None:
                ov = b.alloc_override
                e_alloc[ei] = np.where(np.isnan(ov), lattice.alloc[ti], ov)
            else:
                e_alloc[ei] = lattice.alloc[ti]
            e_type[ei] = ti
            e_zone[ei] = zone_index[b.zone]
            e_cap[ei] = cap_index[b.capacity_type]
            e_np[ei] = pool_index.get(b.node_pool, -1)
        A = prev.A
        return dict(e_used=e_used, e_alloc=e_alloc, e_type=e_type,
                    e_zone=e_zone, e_cap=e_cap, e_np=e_np,
                    e_pm=np.zeros((E, A), np.int32),
                    e_po=np.zeros((E, A), bool))
