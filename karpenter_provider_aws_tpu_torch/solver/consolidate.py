"""The batched consolidation engine.

The port of the JAX package's ``solver/consolidate.py``, whole (its
behavioral spec is that package's docs/reference/consolidation.md).
Consolidation's search — "remove candidate set S: do its pods fit on the
remaining capacity plus at most one new, cheaper node?" — is a batch of
what-if re-solves over one shared cluster problem. This module makes
that batch a first-class solver workload around the batched probe pack
(`Solver.probe_batch` / ops/binpack.pack_probe_fused: the scan vmapped
over the probes, one cheapest-offering kernel launch over all their bins):

- **dirty-block deltas**: every candidate removal set is expressed as a
  delta against the resident cluster problem — the set's bins masked
  out of the existing-bin table, its evictee pods re-entering as pending
  groups — and the whole candidate batch rides ONE vmapped dispatch
  over the candidate axis.
- **zero-leg cache**: probe verdicts are cached per candidate set and
  invalidated through the cluster mirror's journal-tagged bin names
  (state/cluster.py DirtySet.bin_names). A pass whose base problem did
  not move (pending-pod churn only, pure candidate-frontier drift)
  serves fingerprint-unchanged candidates from the cache at ZERO device
  sync legs; an unlocalizable mutation clears the cache — the
  always-correct fallback, never a silently-stale verdict.
- **host fallback, counted**: candidate problems outside the vmapped
  envelope (wave-scale G past the solver's largest group bucket; this
  package has no mesh, so the JAX package's pinned-groups-on-a-mesh
  check never fires) are flagged for the controller's existing exact
  `_what_if` ladder instead of the batch, and counted — the same honesty
  rule the microloop's `micro_aborts` follows.
- **savings referee**: an accepted removal must beat the host FFD
  oracle's costing of the same what-if within the ≤2% envelope
  (`REFEREE_ENVELOPE`) — the device plan may never ride a decode bug
  into a "saving" the reference packer would not certify.
- **coded skip reasons**: every node NOT consolidated gets a
  solver/taxonomy.py code (not-consolidatable-pdb | -budget |
  consolidation-no-savings | -weather-hold | -spot-guard) recorded in
  the per-node ledger, the decision-audit ring (`kpctl explain node`),
  and the karpenter_disruption_consolidation_skips_total code label.
- **weather gate**: an attached advisory (the JAX package's
  weather/simulator.py ``consolidation_advisory``) HOLDS voluntary
  consolidation through an
  active storm or spot-crash regime window — consolidating INTO
  distressed capacity trades a standing node for one about to be
  reclaimed. An ice-age never holds: capacity held OUT of the market
  makes packing what remains more valuable, not less.

Probe verdicts stay optimistic (soft constraints fully relaxed) — the
controller re-verifies any winner with one exact solve plus the referee
before a single node is touched, so a stale or optimistic probe can cost
a bounded wasted solve, never an incorrect eviction.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..lattice.tensors import masked_view_versioned
from ..metrics import Registry, wire_core_metrics
from ..utils.clock import Clock
from . import taxonomy
from .solve import ProbeResult, Solver

# the savings referee's envelope: the device plan's replacement cost may
# exceed the host FFD oracle's costing of the same what-if by at most
# this fraction
REFEREE_ENVELOPE = 0.02

# per-node skip ledger bound (newest wins; consolidation candidate sets
# are already capped well below this per pass)
_LEDGER_MAX = 512

# a probe-batch verdict whose set could not be evaluated (snapshot drift
# removed a member's node mid-pass): reported infeasible, never shrunk
_DEAD = ProbeResult(feasible=False, n_new=0, new_cost=0.0,
                    new_cap_type=None, flex=0)


@dataclass(frozen=True)
class SetVerdict:
    """One candidate removal set's evaluation, aligned with the caller's
    probe_sets order."""

    probe: ProbeResult
    removed_price: float     # $/hr of the set's standing capacity
    cached: bool = False     # served from the zero-leg delta cache
    host: bool = False       # outside the vmapped envelope: exact-
                             # verify on the host _what_if ladder


class ConsolidationEngine:
    """Batched what-if dispatch + referee + skip-reason ledger for the
    disruption controller's consolidation method."""

    def __init__(self, cluster, solver: Solver, node_pools: Dict,
                 unavailable, clock: Optional[Clock] = None,
                 metrics: Optional[Registry] = None, audit=None):
        self.cluster = cluster
        self.solver = solver
        self.node_pools = node_pools
        self.unavailable = unavailable
        self.clock = clock or Clock()
        self.audit = audit
        # {"hold": bool, "reason": str} supplier — soak/smoke wire the
        # weather simulator's consolidation_advisory here; None = fair
        self.weather_advisory: Optional[Callable[[], Dict]] = None
        self._lock = threading.Lock()
        m = wire_core_metrics(metrics or Registry())
        self._m_dispatches = m["disruption_vmapped_whatifs"]
        self._m_candidates = m["disruption_whatif_candidates"]
        self._m_cached = m["disruption_whatif_cached"]
        self._m_fallbacks = m["disruption_whatif_host_fallbacks"]
        self._m_skips = m["disruption_consolidation_skips"]
        self._m_savings = m["disruption_consolidation_savings"]
        self.counters: Dict[str, float] = {
            "vmapped_whatifs": 0,      # batched dispatches (kernel launches)
            "batched_candidates": 0,   # candidate sets across dispatches
            "fp_unchanged": 0,         # sets served from cache (zero legs)
            "host_fallbacks": 0,       # sets outside the vmapped envelope
            "cache_invalidations": 0,  # whole-cache clears
            "accepted": 0,             # removals begun
            "nodes_consolidated": 0,   # claims across accepted removals
            "savings_per_hour": 0.0,   # cumulative accepted $/hr savings
            "referee_checks": 0,
            "referee_rejects": 0,
            "weather_holds": 0,        # passes held by the advisory
        }
        self._skips: Dict[str, int] = {}              # code -> count
        self._ledger: Dict[str, Dict] = {}            # node -> last skip
        self._last_batch = 0                          # sets in last dispatch
        # zero-leg delta cache: (sorted member claim names) ->
        # (ProbeResult, removed $/hr), valid while the base problem's
        # fingerprint (journal anchor + price + unavailability) holds
        self._cache: Dict[Tuple[str, ...], Tuple[ProbeResult, float]] = {}
        self._anchor_rev: Optional[int] = None
        self._anchor_price: Optional[int] = None
        self._anchor_unavail: Optional[int] = None

    # ---- weather gate ----------------------------------------------------

    def weather_hold(self) -> str:
        """The advisory's hold reason ("" = consolidate freely)."""
        adv = self.weather_advisory
        if adv is None:
            return ""
        try:
            verdict = adv()
        except Exception:
            return ""    # a broken advisory must never wedge disruption
        if verdict and verdict.get("hold"):
            return str(verdict.get("reason") or "weather")
        return ""

    def note_weather_hold(self, node_names: Sequence[str],
                          reason: str) -> None:
        """One held pass: count it and ledger every candidate node."""
        with self._lock:
            self.counters["weather_holds"] += 1
        for n in node_names:
            self.note_skip(n, taxonomy.CONSOLIDATION_WEATHER_HOLD, reason)

    # ---- skip ledger -----------------------------------------------------

    def note_skip(self, node_name: str, code: str, detail: str = "") -> None:
        """Record "why was this node NOT consolidated": the coded metric
        label, the per-node ledger, and the decision-audit ring."""
        assert code in taxonomy.CODES, code
        now = self.clock.now()
        with self._lock:
            self._skips[code] = self._skips.get(code, 0) + 1
            self._ledger[node_name] = {
                "code": code, "detail": detail, "t": round(now, 3)}
            while len(self._ledger) > _LEDGER_MAX:
                self._ledger.pop(next(iter(self._ledger)))
        self._m_skips.inc(code=code)
        if self.audit is not None:
            self.audit.record_node(node_name, code, detail, t=now)

    def note_accept(self, removed, savings_per_hour: float) -> None:
        """An accepted removal: savings bookkeeping + ledger clear for
        the consolidated nodes (they are no longer 'not consolidated')."""
        with self._lock:
            self.counters["accepted"] += 1
            self.counters["nodes_consolidated"] += len(removed)
            self.counters["savings_per_hour"] += float(savings_per_hour)
            self._m_savings.set(self.counters["savings_per_hour"])
            for c in removed:
                self._ledger.pop(c.name, None)

    # ---- zero-leg delta cache --------------------------------------------

    def _cache_key(self, removed) -> Tuple[str, ...]:
        return tuple(sorted(c.name for c in removed))

    def _refresh_cache(self) -> None:
        """Validate the cache against the journal since the last
        dispatch. Any bin-table movement, unlocalizable mutation, price
        refresh, or unavailability change invalidates everything — a
        what-if's answer depends on the WHOLE remaining bin table, so
        per-set surgical retention would be wrong for any bin change.
        What survives (the dominant steady-state case): pending-pod
        churn and pure candidate-frontier drift, which don't move the
        base problem at all."""
        rev = self.cluster.state_rev
        price = self.solver.lattice.price_version
        unavail = self.unavailable.seq_num
        if self._anchor_rev is None:
            self._anchor_rev, self._anchor_price = rev, price
            self._anchor_unavail = unavail
            return
        stale = (price != self._anchor_price
                 or unavail != self._anchor_unavail)
        if not stale and rev != self._anchor_rev:
            ds = self.cluster.dirty_since(self._anchor_rev)
            stale = (ds.full or ds.other or ds.volumes or ds.daemonsets
                     or ds.bins)
        if stale and self._cache:
            self._cache.clear()
            with self._lock:
                self.counters["cache_invalidations"] += 1
        self._anchor_rev, self._anchor_price = rev, price
        self._anchor_unavail = unavail

    # ---- the vmapped envelope --------------------------------------------

    def _vmap_ineligible(self, problem) -> str:
        """Mirror of the microloop's envelope checks (Solver._solve_micro
        _MicroIneligible): the reason this candidate problem cannot ride
        the vmapped probe batch, or "". Without a mesh only the group
        axis can put a problem outside it."""
        if problem.G > self.solver._g_ceiling():
            return "wave-scale G"
        return ""

    # ---- what-if problem construction ------------------------------------

    def _removed_price(self, lattice, removed) -> float:
        import numpy as np
        total = 0.0
        for c in removed:
            ti = lattice.name_to_idx.get(c.instance_type)
            if ti is None:
                continue
            zi = lattice.zones.index(c.zone) if c.zone in lattice.zones else 0
            ci = (lattice.capacity_types.index(c.capacity_type)
                  if c.capacity_type in lattice.capacity_types else 0)
            p = self.solver.lattice.price[ti, zi, ci]
            total += float(p) if np.isfinite(p) else 0.0
        return total

    def _whatif_problem(self, removed, lattice, all_bins, bound_all,
                        pvcs, storage_classes, ds, pools, node_of,
                        pods_of) -> object:
        """One candidate set's dirty-block delta as a scratch problem:
        member bins masked out of the table, evictee pods re-entering as
        pending groups. ``pods_of(claim_name)`` supplies the (possibly
        relaxed) evictee pods."""
        from .problem import build_problem
        removed_nodes = {node_of[c.name] for c in removed}
        removed_names = {c.name for c in removed}
        pods = [p for c in removed for p in pods_of(c.name)]
        existing = [b for b in all_bins
                    if b.name not in removed_nodes
                    and b.name not in removed_names]
        bound = [bp for bp in bound_all
                 if bp.node_name not in removed_nodes]
        return build_problem(
            pods, pools, lattice, existing=existing, daemonset_pods=ds,
            bound_pods=bound, pvcs=pvcs, storage_classes=storage_classes)

    # ---- the batched dispatch --------------------------------------------

    def probe(self, removed_sets: Sequence[Sequence],
              node_by_claim=None, by_node=None) -> List[SetVerdict]:
        """Evaluate every candidate removal set: cached verdicts at zero
        legs, the rest as ONE vmapped probe dispatch, envelope misfits
        flagged for the host ladder. Aligned with ``removed_sets``."""
        from ..apis.objects import relax_pod, relaxation_depth

        self._refresh_cache()
        verdicts: List[Optional[SetVerdict]] = [None] * len(removed_sets)
        misses: List[int] = []
        n_cached = n_fallback = 0
        for i, removed in enumerate(removed_sets):
            if not removed:
                verdicts[i] = SetVerdict(_DEAD, 0.0)
                continue
            hit = self._cache.get(self._cache_key(removed))
            if hit is not None:
                # the cache survived _refresh_cache, so no bin/price/
                # unavailability moved since the verdict: the set's nodes
                # still stand and the verdict still holds — zero legs AND
                # zero snapshot rebuilds for a fully-cached pass
                verdicts[i] = SetVerdict(hit[0], hit[1], cached=True)
                n_cached += 1
                continue
            misses.append(i)

        batch_problems, batch_idx, batch_prices = [], [], []
        if misses:
            lattice = masked_view_versioned(self.solver.lattice,
                                            self.unavailable)
            if node_by_claim is None:
                node_by_claim = self.cluster.nodes_by_claim()
            if by_node is None:
                by_node = self.cluster.pods_by_node(
                    include_daemonsets=False)
            all_bins = self.cluster.existing_bins(lattice)
            bound_all = self.cluster.bound_pods()
            pvcs, storage_classes = self.cluster.volume_state()
            ds = self.cluster.daemonset_pods()
            pools = list(self.node_pools.values())

            valid = {i: all(c.name in node_by_claim for c in removed_sets[i])
                     for i in misses}
            claim_names = {c.name for i in misses if valid[i]
                           for c in removed_sets[i]}
            node_of = {n: node_by_claim[n].name for n in claim_names}
            relaxed: Dict[str, object] = {}
            for n in claim_names:
                for p in by_node.get(node_of[n], ()):
                    if p.name not in relaxed:
                        relaxed[p.name] = relax_pod(p, relaxation_depth(p))

            def pods_of(claim_name):
                return [relaxed[p.name]
                        for p in by_node.get(node_of[claim_name], ())]

            for i in misses:
                removed = removed_sets[i]
                if not valid[i]:
                    # snapshot drift removed a member's node: reported
                    # infeasible, never silently shrunk — verdicts must
                    # stay aligned with the caller's sets
                    verdicts[i] = SetVerdict(_DEAD, 0.0)
                    continue
                price = self._removed_price(lattice, removed)
                problem = self._whatif_problem(
                    removed, lattice, all_bins, bound_all, pvcs,
                    storage_classes, ds, pools, node_of, pods_of)
                why = self._vmap_ineligible(problem)
                if why:
                    # outside the envelope: the controller exact-verifies
                    # on the host _what_if ladder under its budget —
                    # flagged, counted, never silently dropped
                    verdicts[i] = SetVerdict(_DEAD, price, host=True)
                    n_fallback += 1
                    continue
                batch_problems.append(problem)
                batch_idx.append(i)
                batch_prices.append(price)

        probed = (self.solver.probe_batch(batch_problems)
                  if batch_problems else [])
        for pr, i, price in zip(probed, batch_idx, batch_prices):
            verdicts[i] = SetVerdict(pr, price)
            self._cache[self._cache_key(removed_sets[i])] = (pr, price)
        # verdicts cached under the CURRENT anchor (refreshed above)
        with self._lock:
            if batch_problems:
                self.counters["vmapped_whatifs"] += 1
                self.counters["batched_candidates"] += len(batch_problems)
                self._last_batch = len(batch_problems)
            self.counters["fp_unchanged"] += n_cached
            self.counters["host_fallbacks"] += n_fallback
        if batch_problems:
            self._m_dispatches.inc()
            self._m_candidates.inc(len(batch_problems))
        if n_cached:
            self._m_cached.inc(n_cached)
        if n_fallback:
            self._m_fallbacks.inc(n_fallback)
        return [v if v is not None else SetVerdict(_DEAD, 0.0)
                for v in verdicts]

    # ---- the savings referee ---------------------------------------------

    def referee(self, removed, plan, node_by_claim=None,
                by_node=None) -> Tuple[bool, float]:
        """Cost the same what-if with the host FFD oracle and accept the
        device plan only within the ≤2% envelope. Returns (accepted,
        device/oracle cost ratio; 0.0 when the oracle has no costing —
        an FFD that cannot place the evictees cannot out-cost a plan
        that does)."""
        if node_by_claim is None:
            node_by_claim = self.cluster.nodes_by_claim()
        if by_node is None:
            by_node = self.cluster.pods_by_node(include_daemonsets=False)
        live = [c for c in removed if c.name in node_by_claim]
        with self._lock:
            self.counters["referee_checks"] += 1
        if not live:
            return True, 0.0
        lattice = masked_view_versioned(self.solver.lattice,
                                        self.unavailable)
        node_of = {c.name: node_by_claim[c.name].name for c in live}

        def pods_of(claim_name):
            return list(by_node.get(node_of[claim_name], ()))

        problem = self._whatif_problem(
            live, lattice, self.cluster.existing_bins(lattice),
            self.cluster.bound_pods(), *self.cluster.volume_state(),
            self.cluster.daemonset_pods(), list(self.node_pools.values()),
            node_of, pods_of)
        oracle = self.solver.solve_host_ffd(problem)
        if oracle.unschedulable:
            return True, 0.0
        bound = oracle.new_node_cost * (1.0 + REFEREE_ENVELOPE) + 1e-9
        ok = plan.new_node_cost <= bound
        ratio = (plan.new_node_cost / oracle.new_node_cost
                 if oracle.new_node_cost > 0.0
                 else (1.0 if plan.new_node_cost <= 0.0 else float("inf")))
        if not ok:
            with self._lock:
                self.counters["referee_rejects"] += 1
        return ok, ratio

    # ---- introspection ---------------------------------------------------

    def stats(self) -> Dict[str, float]:
        """The ``consolidation`` introspection provider (CONSOLIDATION
        row in kpctl top; sampled into soak artifacts): flat numeric."""
        with self._lock:
            out: Dict[str, float] = {
                k: (round(v, 6) if isinstance(v, float) else float(v))
                for k, v in self.counters.items()}
            out["probe_cache_size"] = float(len(self._cache))
            out["last_batch"] = float(self._last_batch)
            out["ledger_size"] = float(len(self._ledger))
            for code, n in sorted(self._skips.items()):
                out["skip_" + code.replace("-", "_")] = float(n)
            return out

    def headroom_probe(self) -> Dict[str, float]:
        """Zero-leg probe-cache occupancy (introspect/headroom.py).
        Unbounded dict in code, but bounded in practice by the candidate
        frontier — a fill rate that never drains means the invalidation
        anchors stopped firing. drops = whole-cache invalidations."""
        with self._lock:
            inval = self.counters["cache_invalidations"]
        return {"depth": float(len(self._cache)), "capacity": 0.0,
                "drops": float(inval)}

    def ledger_doc(self) -> Dict[str, Dict]:
        """Per-node skip ledger snapshot (`kpctl explain node` falls back
        here via the audit ring; /debug/explain?node= serves the ring)."""
        with self._lock:
            return {k: dict(v) for k, v in self._ledger.items()}
