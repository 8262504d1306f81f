"""Disruption controller: expiration → drift → emptiness → consolidation.

Mirror of the core disruption orchestration (reference website
concepts/disruption.md:16-27 method order; designs/consolidation.md
deletion-vs-replacement and cost rules; budgets math disruption.md:193-222
+ CRD karpenter.sh_nodepools.yaml:55-100). The consolidation simulation —
"remove candidate set S: do its pods fit on the remaining nodes plus at
most one new, cheaper node?" — is exactly a what-if Solve() on the device:
candidate bins drop out of the existing-bin table, their pods re-enter as
pending, and the same grouped-FFD kernel answers feasibility and the
replacement's price in one pass (SURVEY.md §2.2: the second workload the
north star moves on-device).

Method semantics:
- expiration: claims older than the pool's expire_after are replaced.
- drift: CloudProvider.IsDrifted or a NodePool template-hash mismatch
  (feature-gated, settings.md:40-47).
- emptiness: nodes with no non-daemonset pods after consolidate_after are
  deleted in parallel (disruption.md:93 "empty nodes first").
- consolidation (WhenUnderutilized): multi-node first — the largest
  candidate prefix (sorted by disruption cost) whose pods repack onto the
  remaining capacity + ≤1 cheaper node — then single-node scan
  (disruption.md:93-98). Spot→spot replacement requires ≥15-type
  flexibility and its feature gate (disruption.md:129).

Replacement safety: replacements launch FIRST; originals are drained only
after every replacement's node registers (disruption.md:23-25).

The consolidation method's what-if dispatch, zero-leg probe cache, host
fallback, savings referee, weather gate, and "why NOT consolidated" skip
ledger live in solver/consolidate.ConsolidationEngine (constructed here as
``self.engine``; docs/reference/consolidation.md). This controller keeps
the policy: method order, budgets, candidate ranking, the prefix ladder +
single-node scan, and launch-before-drain.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import trace
from ..apis import wellknown as wk
from ..apis.objects import NodeClaim, NodeClaimPhase, NodePool, Pod
from ..cache.unavailable import UnavailableOfferings
from ..cloudprovider.cloudprovider import CloudProvider
from ..errors import UnfulfillableCapacityError
from ..events import Recorder
from ..lattice.tensors import masked_view_versioned
from ..metrics import Registry, wire_core_metrics
from ..solver import taxonomy
from ..solver.consolidate import ConsolidationEngine
from ..solver.solve import NodePlan, ProbeResult, Solver
from ..state.cluster import ClusterState
from ..utils.clock import Clock
from .provisioning import Provisioner, nodepool_hash
from .termination import TerminationController

SPOT_TO_SPOT_MIN_TYPES = 15   # disruption.md:129
CONSOLIDATION_SAVINGS_EPS = 1e-4


@dataclass
class DisruptionAction:
    reason: str                       # Expired | Drifted | Empty | Underutilized
    claims: List[str]                 # originals to remove
    replacements: List[str] = field(default_factory=list)  # claim names launched
    def __post_init__(self):
        self.claims = list(self.claims)


class DisruptionController:
    def __init__(self, cluster: ClusterState, solver: Solver,
                 node_pools: Dict[str, NodePool],
                 cloud_provider: CloudProvider,
                 provisioner: Provisioner,
                 termination: TerminationController,
                 unavailable: UnavailableOfferings,
                 recorder: Optional[Recorder] = None,
                 clock: Optional[Clock] = None,
                 drift_enabled: bool = True,
                 spot_to_spot_consolidation: bool = False,
                 metrics: Optional[Registry] = None,
                 writer=None):
        self.cluster = cluster
        self.solver = solver
        self.node_pools = node_pools
        self.cloud_provider = cloud_provider
        self.provisioner = provisioner
        self.termination = termination
        self.unavailable = unavailable
        self.clock = clock or Clock()
        from ..kube.writer import DirectWriter
        self.writer = writer or DirectWriter(cluster, self.clock)
        self.recorder = recorder or Recorder(self.clock)
        self.drift_enabled = drift_enabled
        self.spot_to_spot_consolidation = spot_to_spot_consolidation
        m = wire_core_metrics(metrics or Registry())
        self._m_disrupted = m["nodeclaims_disrupted"]
        self._in_flight: List[DisruptionAction] = []
        # per-pass what-if budget (the reference bounds each disruption loop
        # with a timeout; we bound by solve count) + a state fingerprint so
        # an unchanged cluster never re-runs a failed consolidation search
        self.max_whatif_per_pass = 16
        self._whatif_used = 0
        self._last_failed_fingerprint = None
        # where the next pass's single-node scan resumes after a
        # budget-truncated pass (so repeat passes verify NEW candidates
        # instead of deterministically repeating the same window)
        self._scan_cursor = 0
        # coverage accounting for the negative cache: a failed pass may
        # only be cached once every candidate in the frontier has been
        # probed as a single under the CURRENT fingerprint — a pass whose
        # probe window or what-if budget covered part of the frontier
        # proved nothing about the rest (see _reconcile_once)
        self._covered: set = set()
        self._last_search_fp = None
        self._last_frontier: set = set()
        self._search_truncated = False
        # the vmapped what-if engine: batched candidate dispatch, zero-leg
        # probe cache, host fallback, savings referee, weather gate, and
        # the per-node skip-reason ledger (kpctl explain node)
        self.engine = ConsolidationEngine(
            cluster, solver, node_pools, unavailable, clock=self.clock,
            metrics=metrics, audit=getattr(provisioner, "explain", None))
        # (node, pdb) pairs whose Unconsolidatable event already published
        # for the current blockage episode (see _candidates)
        self._pdb_blocked_logged: set = set()
        # parsed budget schedules (False = invalid), per controller
        self._cron_cache: Dict[str, object] = {}
        # (schedule, duration) -> (valid_until, active): windows open only
        # at minute marks, so a closed verdict holds to the next minute;
        # an open one re-verifies each minute (it may linger <=60s past a
        # mid-minute close — the conservative, MORE-constrained direction)
        self._window_cache: Dict[Tuple[str, float], Tuple[float, bool]] = {}

    # one batched probe covers the prefix ladder + single-node scan; caps
    # bound the padded K bucket (solver.Solver._K_BUCKETS)
    MAX_PREFIX_PROBES = 16
    MAX_SINGLE_PROBES = 16

    # ---- budgets (disruption.md:193-222) ---------------------------------

    def _allowed_disruptions(self, pool: NodePool, reason: str) -> int:
        total = sum(1 for c in self.cluster.snapshot_claims()
                    if c.node_pool == pool.name and not c.deletion_timestamp)
        disrupting = sum(1 for a in self._in_flight for n in a.claims
                         if n in self.cluster.claims
                         and self.cluster.claims[n].node_pool == pool.name)
        allowed = total
        for budget in pool.disruption.budgets:
            if budget.reasons and reason not in budget.reasons:
                continue
            if budget.schedule is not None and not self._budget_active(budget):
                # a scheduled budget constrains only inside its window
                # (disruption.md:193-222; CRD requires schedule+duration
                # together — webhooks.validate_node_pool enforces that)
                continue
            spec = str(budget.nodes)
            if spec.endswith("%"):
                # percentages round UP (disruption.md: "4 disruptions ...
                # rounding up from 19 * .2 = 3.8")
                val = int(np.ceil(total * float(spec[:-1]) / 100.0))
            else:
                val = int(spec)
            allowed = min(allowed, max(val, 0))
        return max(allowed - disrupting, 0)

    def _budget_active(self, budget) -> bool:
        """Is the budget's scheduled window open right now? (An invalid
        schedule — rejected by admission anyway — never constrains.)

        Results memoize per (schedule, duration): an open window stays
        open until its close; a closed one cannot open before the next
        whole minute — so the lookback scan runs at most once a minute
        per budget instead of on every reconcile and fingerprint."""
        from ..utils.cron import Cron
        cron = self._cron_cache.get(budget.schedule)
        if cron is None:
            try:
                cron = Cron(budget.schedule)
            except ValueError:
                cron = False
            self._cron_cache[budget.schedule] = cron
        if cron is False:
            return False
        now = self.clock.now()
        duration = budget.duration or 0.0
        key = (budget.schedule, duration)
        cached = self._window_cache.get(key)
        if cached is not None and now < cached[0]:
            return cached[1]
        active = cron.in_window(now, duration)
        valid_until = (now // 60 + 1) * 60 if not active else now + 60.0
        self._window_cache[key] = (valid_until, active)
        return active

    def _budget_window_state(self) -> Tuple:
        """(pool, budget index, active) for every scheduled budget — part
        of the consolidation fingerprint: a window opening or closing is
        pure time passage that changes what disruption may do, so it must
        re-arm a negative-cached search."""
        out = []
        for pool in self.node_pools.values():
            for i, b in enumerate(pool.disruption.budgets):
                if b.schedule is not None:
                    out.append((pool.name, i, self._budget_active(b)))
        return tuple(out)

    # ---- candidate discovery --------------------------------------------

    def _candidates(self) -> List[NodeClaim]:
        """Initialized, healthy, not-already-disrupting claims with a
        registered node. Voluntary-disruption opt-outs are respected here:
        a `karpenter.sh/do-not-disrupt` annotation on the claim (NodePool
        template annotations land there), on the node, or on any of its
        pods removes the node from candidacy (reference
        disruption.md:253,282,294), and so does a pod whose
        PodDisruptionBudgets currently allow zero evictions (the
        `pdb ... prevents pod evictions` Unconsolidatable condition,
        disruption.md:112)."""
        in_flight = {n for a in self._in_flight for n in a.claims}
        node_by_claim = self.cluster.nodes_by_claim()
        # unfiltered: a do-not-disrupt DAEMONSET pod pins its node too;
        # pdb_blockers applies its own daemonset exemption
        pods_by_node = self.cluster.pods_by_node()
        # allowance is node-independent: one sweep for the whole pass
        zero_pdbs = self.cluster.zero_allowance_pdbs()
        blocked_now: set = set()
        out = []
        for claim in self.cluster.snapshot_claims():
            if claim.deletion_timestamp or claim.name in in_flight:
                continue
            if claim.phase != NodeClaimPhase.INITIALIZED:
                continue
            if claim.name not in node_by_claim:
                continue
            if claim.node_pool not in self.node_pools:
                continue
            node = node_by_claim[claim.name]
            if (claim.annotations.get(wk.ANNOTATION_DO_NOT_DISRUPT) == "true"
                    or node.annotations.get(wk.ANNOTATION_DO_NOT_DISRUPT) == "true"):
                continue
            pods = pods_by_node.get(node.name, [])
            if any(p.annotations.get(wk.ANNOTATION_DO_NOT_DISRUPT) == "true"
                   for p in pods):
                continue
            blocked = self.cluster.pdb_blockers(pods, zero_pdbs=zero_pdbs)
            if blocked:
                pod, pdb = next(iter(blocked.items()))
                # publish once per (node, pdb) blockage episode, not per
                # pass — _candidates runs from every disruption method
                # every reconcile and the recorder must not flood
                key = (node.name, pdb)
                blocked_now.add(key)
                if key not in self._pdb_blocked_logged:
                    self._pdb_blocked_logged.add(key)
                    self.recorder.publish(
                        "Normal", "Unconsolidatable", "Node", node.name,
                        f"pdb {pdb} prevents pod evictions (pod {pod})")
                    # same episode dedup keeps the event, the skip metric
                    # label, and the explain ledger in lockstep
                    self.engine.note_skip(
                        node.name, taxonomy.NOT_CONSOLIDATABLE_PDB,
                        f"pdb {pdb} prevents pod evictions (pod {pod})")
                continue
            out.append(claim)
        # unblocked pairs may re-publish if they block again later
        self._pdb_blocked_logged &= blocked_now
        return out

    def _pods_on(self, claim: NodeClaim) -> List[Pod]:
        node = self.cluster.node_for_claim(claim.name)
        if node is None:
            return []
        return [p for p in self.cluster.snapshot_pods()
                if p.node_name == node.name and not p.is_daemonset]

    def _disruption_cost(self, claim: NodeClaim) -> float:
        """Cheapest-to-disrupt first (consolidation.md disruption-cost
        scoring: fewer/lower-priority pods = cheaper to move)."""
        return float(sum(1 + p.priority for p in self._pods_on(claim)))

    # ---- what-if solve (the on-device consolidation query) ---------------

    def _removed_price(self, lattice, removed: Sequence[NodeClaim]) -> float:
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

    def _what_if(self, removed: Sequence[NodeClaim]) -> Tuple[NodePlan, float]:
        """Solve the cluster with `removed` gone; returns (plan, removed $/hr).

        A candidate's node can vanish between candidate selection and this
        solve (interruption/GC run concurrently under the threaded
        runtime). Vanished-node claims are filtered from the WHOLE
        what-if — exclusion set, pod set, AND the removed price — with one
        consistent snapshot: counting a gone claim's price while
        re-placing none of its pods would over-credit the savings and
        admit unprofitable disruptions."""
        self._whatif_used += 1
        lattice = masked_view_versioned(self.solver.lattice,
                                        self.unavailable)
        node_by_claim = self.cluster.nodes_by_claim()
        by_node = self.cluster.pods_by_node(include_daemonsets=False)
        live = [c for c in removed if c.name in node_by_claim]
        removed_nodes = {node_by_claim[c.name].name for c in live}
        pods = [p for c in live
                for p in by_node.get(node_by_claim[c.name].name, ())]
        existing = [b for b in self.cluster.existing_bins(lattice)
                    if b.name not in removed_nodes
                    and b.name not in {c.name for c in live}]
        bound = [bp for bp in self.cluster.bound_pods()
                 if bp.node_name not in removed_nodes]
        pvcs, storage_classes = self.cluster.volume_state()
        plan = self.solver.solve_relaxed(
            pods, list(self.node_pools.values()), lattice,
            existing=existing, daemonset_pods=self.cluster.daemonset_pods(),
            bound_pods=bound, pvcs=pvcs, storage_classes=storage_classes)
        return plan, self._removed_price(lattice, live)

    def _probe_whatifs(self, removed_sets: Sequence[Sequence[NodeClaim]],
                       node_by_claim=None, by_node=None):
        """All of a pass's what-ifs as ONE batched device call — delegated
        to ConsolidationEngine.probe (solver/consolidate.py), which adds
        the zero-leg probe cache and the vmapped-envelope host-fallback
        split. Pods are probed with their soft constraints fully relaxed —
        the loosest state solve_relaxed can reach — so a probe's infeasible
        verdict is trustworthy while a feasible one is optimistic; the
        winning probe is re-verified by one exact _what_if before any node
        is touched. Returns [(ProbeResult, removed $/hr)] aligned with
        removed_sets."""
        verdicts = self.engine.probe(removed_sets,
                                     node_by_claim=node_by_claim,
                                     by_node=by_node)
        return [(v.probe, v.removed_price) for v in verdicts]

    def _within_budgets(self, removed: Sequence[NodeClaim],
                        reason: str) -> bool:
        """Cheap host-side mirror of _begin's per-pool budget gate, so the
        search never pays an exact device solve for a candidate set the
        budget is guaranteed to reject."""
        counts: Dict[str, int] = {}
        for c in removed:
            counts[c.node_pool] = counts.get(c.node_pool, 0) + 1
        return all(
            self._allowed_disruptions(self.node_pools[p], reason) >= n
            for p, n in counts.items())

    def _probe_ok(self, removed: Sequence[NodeClaim], pr,
                  removed_price: float) -> bool:
        """The consolidation criterion on probe aggregates (mirrors the
        exact-plan checks in _reconcile_consolidation)."""
        if not pr.feasible or pr.n_new > 1:
            return False
        if pr.new_cost >= removed_price - CONSOLIDATION_SAVINGS_EPS:
            return False
        if (pr.n_new == 1 and pr.new_cap_type == wk.CAPACITY_TYPE_SPOT
                and any(c.capacity_type == wk.CAPACITY_TYPE_SPOT
                        for c in removed)):
            if not self.spot_to_spot_consolidation:
                return False
            if pr.flex < SPOT_TO_SPOT_MIN_TYPES:
                return False
        return True

    def _spot_guard_ok(self, removed: Sequence[NodeClaim], plan: NodePlan) -> bool:
        """Spot→spot single-node replacement needs ≥15-type flexibility and
        the feature gate (disruption.md:129)."""
        if not plan.new_nodes:
            return True
        if not any(c.capacity_type == wk.CAPACITY_TYPE_SPOT for c in removed):
            return True
        if not any(n.capacity_type == wk.CAPACITY_TYPE_SPOT for n in plan.new_nodes):
            return True
        if not self.spot_to_spot_consolidation:
            return False
        return all(len(n.feasible_types) >= SPOT_TO_SPOT_MIN_TYPES
                   for n in plan.new_nodes
                   if n.capacity_type == wk.CAPACITY_TYPE_SPOT)

    # ---- reconcile --------------------------------------------------------

    def _consolidatable(self) -> List[NodeClaim]:
        """Candidates whose pool policy + consolidate_after window currently
        allow consolidation."""
        now = self.clock.now()
        out = []
        for claim in self._candidates():
            pool = self.node_pools[claim.node_pool]
            if pool.disruption.consolidation_policy != "WhenUnderutilized":
                continue
            after = pool.disruption.consolidate_after
            if after is not None:
                ref = claim.initialized_at or claim.created_at
                if now - ref < after:
                    continue
            out.append(claim)
        return out

    def _fingerprint(self, consolidatable: Optional[Sequence[NodeClaim]] = None):
        if consolidatable is None:
            consolidatable = self._consolidatable()
        return (
            tuple(sorted((p.name, p.node_name or "") for p in self.cluster.snapshot_pods())),
            tuple(sorted(self.cluster.claims)),
            self.unavailable.seq_num,
            # a pricing refresh can turn a previously-unprofitable
            # consolidation profitable: re-search after one
            self.solver.lattice.price_version,
            len(self._in_flight),
            # the negative cache must expire when a consolidate_after window
            # elapses: pure time passage changes which candidates are
            # eligible even though no pod/claim moved
            tuple(sorted(c.name for c in consolidatable)),
            # ... and when a scheduled budget's window opens or closes
            self._budget_window_state(),
            # ... and when a budget SPEC is edited (an unscheduled
            # budget has no window state, but raising its nodes value
            # un-blocks candidates the last search skipped)
            tuple(sorted(
                (p.name, tuple((str(b.nodes), b.schedule, b.duration,
                                tuple(b.reasons))
                               for b in p.disruption.budgets))
                for p in self.node_pools.values())),
        )

    def reconcile(self) -> None:
        # the pass is spanned so a disruption decision (probes, the
        # replacement re-solve, cordons) shows up in the flight recorder
        # as one causal tree; a pass that DECIDED NOTHING marks its root
        # `discard` and the recorder drops it — an idle reconcile every
        # step must not churn the trace ring
        with trace.span("disruption.reconcile") as sp:
            acted = self._reconcile_once()
            if not acted:
                sp.set(discard=True)

    def _reconcile_once(self) -> bool:
        self._advance_in_flight()
        self._whatif_used = 0
        # one new disruption decision per pass, in method order (the core
        # serializes voluntary disruption the same way)
        if self._reconcile_expiration():
            self._last_failed_fingerprint = None
            return True
        if self.drift_enabled and self._reconcile_drift():
            self._last_failed_fingerprint = None
            return True
        if self._reconcile_emptiness():
            self._last_failed_fingerprint = None
            return True
        consolidatable = self._consolidatable()
        fp = self._fingerprint(consolidatable)
        if fp == self._last_failed_fingerprint:
            return False  # nothing changed since the search came up empty
        if fp != self._last_search_fp:
            # the base state moved: prior passes' coverage proves nothing
            # under the new fingerprint
            self._covered = set()
            self._last_search_fp = fp
        self._search_truncated = False
        frontier = {c.name for c in consolidatable}
        if self._reconcile_consolidation(consolidatable):
            self._last_frontier = frontier
            self._last_failed_fingerprint = None
            return True
        if (self._whatif_used < self.max_whatif_per_pass
                and not self._search_truncated
                and frontier <= self._covered):
            self._last_failed_fingerprint = fp
        # a pass truncated by the what-if budget, the probe window, or a
        # weather hold proved nothing about the candidates it never
        # reached — never negative-cache it; repeat passes keep sweeping
        # (cursor advance + coverage set) until the WHOLE frontier has
        # been probed under this fingerprint
        self._last_frontier = frontier
        return False

    def _advance_in_flight(self) -> None:
        """Drain originals whose replacements have all registered."""
        done: List[DisruptionAction] = []
        for action in self._in_flight:
            ready = all(self.cluster.node_for_claim(r) is not None
                        for r in action.replacements
                        if r in self.cluster.claims)
            lost = [r for r in action.replacements if r not in self.cluster.claims]
            if lost:
                # replacement failed (ICE/liveness): abandon the action
                self.recorder.publish("Warning", "DisruptionAborted", "NodeClaim",
                                      action.claims[0] if action.claims else "",
                                      f"replacement(s) {lost} lost")
                done.append(action)
                continue
            if ready:
                for name in action.claims:
                    claim = self.cluster.claims.get(name)
                    if claim is not None:
                        self._m_disrupted.inc(nodepool=claim.node_pool,
                                              reason=action.reason)
                    self.termination.delete_claim(name)
                    self.recorder.publish("Normal", "Disrupted", "NodeClaim", name,
                                          action.reason)
                done.append(action)
        for a in done:
            self._in_flight.remove(a)

    def _begin(self, reason: str, removed: Sequence[NodeClaim],
               plan: NodePlan,
               max_replacement_cost: Optional[float] = None) -> bool:
        """Launch replacements (if any) then queue the drain.
        ``max_replacement_cost`` re-guards consolidation profitability after
        limit-driven instance-type substitution (a downsized-into-the-limit
        replacement is pricier than the solver's choice by construction)."""
        pool_budgets: Dict[str, int] = {}
        for c in removed:
            pool = self.node_pools[c.node_pool]
            pool_budgets.setdefault(c.node_pool, self._allowed_disruptions(pool, reason))
            if pool_budgets[c.node_pool] <= 0:
                return False
            pool_budgets[c.node_pool] -= 1
        # NodePool resource limits bind replacements exactly like fresh
        # provisioning (nodepools.md limits). Launch-before-drain means the
        # originals still count toward usage here — correct, both exist
        # during the transition. If any replacement cannot fit the limits
        # (even downsized), abort: never drain without standing capacity.
        planned, over_limit = self.provisioner._enforce_limits(
            list(plan.new_nodes))
        if over_limit:
            self.recorder.publish("Warning", "DisruptionBlocked", "NodeClaim",
                                  removed[0].name if removed else "",
                                  f"{reason} replacement exceeds nodepool limits")
            return False
        if max_replacement_cost is not None:
            new_cost = sum(n.price_per_hour for n in planned)
            if new_cost >= max_replacement_cost:
                self.recorder.publish(
                    "Warning", "DisruptionBlocked", "NodeClaim",
                    removed[0].name if removed else "",
                    f"{reason} no longer profitable after limit substitution")
                return False
        # limit substitution may also have narrowed launch flexibility below
        # the spot-to-spot guard's floor — re-check on the final plan
        # (consolidation only: the guard does not apply to drift/expiration
        # replacements, disruption.md:129)
        if reason == "Underutilized" and not self._spot_guard_ok(removed, plan):
            return False
        action = DisruptionAction(reason=reason, claims=[c.name for c in removed])
        for node in planned:
            claim = self.provisioner._make_claim(node)
            self.writer.create_claim(claim)
            try:
                self.cloud_provider.create(claim)
                self.writer.update_claim_status(claim)
            except Exception as e:
                # ICE or any launch failure: roll back — never drain without
                # standing replacement capacity
                self.recorder.publish("Warning", "ReplacementLaunchFailed",
                                      "NodeClaim", claim.name,
                                      f"{reason} disruption aborted: "
                                      f"{type(e).__name__}: {e}")
                for r in action.replacements:
                    self.termination.delete_claim(r)
                self.writer.rollback_claim(claim.name)
                return False
            action.replacements.append(claim.name)
        self._in_flight.append(action)
        return True

    # ---- methods ----------------------------------------------------------

    def _reconcile_expiration(self) -> bool:
        now = self.clock.now()
        for claim in self._candidates():
            pool = self.node_pools[claim.node_pool]
            expire = pool.disruption.expire_after
            if expire is None or now - claim.created_at < expire:
                continue
            plan, _ = self._what_if([claim])
            if plan.unschedulable:
                continue
            if self._begin("Expired", [claim], plan):
                return True
        return False

    def _reconcile_drift(self) -> bool:
        for claim in self._candidates():
            pool = self.node_pools[claim.node_pool]
            reason = self.cloud_provider.is_drifted(claim)
            if reason is None:
                have = claim.annotations.get(wk.ANNOTATION_NODEPOOL_HASH)
                have_ver = claim.annotations.get(
                    wk.ANNOTATION_NODEPOOL_HASH_VERSION)
                from .provisioning import NODEPOOL_HASH_VERSION
                if have is not None and have_ver != NODEPOOL_HASH_VERSION:
                    # hash formula changed between controller versions:
                    # RE-STAMP under the new formula instead of treating
                    # the formula change itself as drift (which would
                    # roll every pre-upgrade node fleet-wide)
                    claim.annotations[wk.ANNOTATION_NODEPOOL_HASH] = \
                        nodepool_hash(pool)
                    claim.annotations[wk.ANNOTATION_NODEPOOL_HASH_VERSION] = \
                        NODEPOOL_HASH_VERSION
                elif have is not None and have != nodepool_hash(pool):
                    reason = "NodePoolDrift"
            if reason is None:
                continue
            plan, _ = self._what_if([claim])
            if plan.unschedulable:
                continue
            if self._begin("Drifted", [claim], plan):
                return True
        return False

    def _reconcile_emptiness(self) -> bool:
        now = self.clock.now()
        empties: List[NodeClaim] = []
        for claim in self._candidates():
            pool = self.node_pools[claim.node_pool]
            after = pool.disruption.consolidate_after
            if after is None:
                continue
            if self._pods_on(claim):
                continue
            ref = claim.initialized_at or claim.created_at
            if now - ref < after:
                continue
            empties.append(claim)
        if not empties:
            return False
        # parallel empty-node delete, budget-capped per pool
        started = False
        by_pool: Dict[str, List[NodeClaim]] = {}
        for c in empties:
            by_pool.setdefault(c.node_pool, []).append(c)
        for pool_name, claims in by_pool.items():
            budget = self._allowed_disruptions(self.node_pools[pool_name], "Empty")
            batch = claims[:budget]
            if not batch:
                continue
            if self._begin("Empty", batch, NodePlan([], {}, {}, 0.0, 0.0, 0.0)):
                started = True
        return started

    def _reconcile_consolidation(
            self, candidates: Optional[List[NodeClaim]] = None) -> bool:
        if candidates is None:
            candidates = self._consolidatable()
        if not candidates:
            return False
        node_by_claim = self.cluster.nodes_by_claim()
        hold = self.engine.weather_hold()
        if hold:
            # never consolidate INTO an active storm or spot-crash window
            # (weather/simulator.py consolidation_advisory; an ice-age
            # never holds). A held pass proved nothing — mark it truncated
            # so it is not negative-cached and the search resumes the
            # moment the advisory clears.
            self.engine.note_weather_hold(
                [node_by_claim[c.name].name for c in candidates
                 if c.name in node_by_claim], hold)
            self._search_truncated = True
            return False
        # cheapest-to-disrupt first (consolidation.md scoring) off one
        # locked snapshot instead of an O(pods) scan per candidate
        by_node = self.cluster.pods_by_node(include_daemonsets=False)
        cost = {c.name: float(sum(
            1 + p.priority
            for p in by_node.get(node_by_claim[c.name].name, ())))
            for c in candidates if c.name in node_by_claim}
        candidates = [c for c in candidates if c.name in node_by_claim]
        if not candidates:
            return False  # snapshot drift removed every candidate's node
        candidates.sort(key=lambda c: cost[c.name])
        K = len(candidates)

        # the whole pass's search — every prefix of the cheapest-first
        # ladder (disruption.md:93-98) AND the single-node scan — is ONE
        # batched device probe (SURVEY §2.2 "embarrassingly batchable");
        # only the winning candidate set pays an exact decode solve, so a
        # pass costs ≤2 device calls instead of O(log n + budget) round
        # trips. Probing each prefix independently also beats the old
        # binary search when feasibility is not monotone in the prefix.
        if K > 1:
            ks = sorted({int(round(k)) for k in
                         np.linspace(2, K, min(K - 1, self.MAX_PREFIX_PROBES))})
        else:
            ks = []
        start = self._scan_cursor % K
        rotated = candidates[start:] + candidates[:start]
        # candidates that entered the frontier since the last pass jump
        # the window queue: a budget- or window-truncated sweep must
        # re-verify NEW candidates next pass, not make them wait a full
        # rotation behind ones already probed (stable sort keeps the
        # cheapest-first order within each class)
        new_names = {c.name for c in candidates} - self._last_frontier
        if new_names:
            rotated.sort(key=lambda c: c.name not in new_names)
        singles = rotated[: self.MAX_SINGLE_PROBES]
        probe_sets = [candidates[:k] for k in ks] + [[c] for c in singles]
        verdicts = self.engine.probe(probe_sets, node_by_claim=node_by_claim,
                                     by_node=by_node)
        n_prefix = len(ks)
        # the prefix ladder may only spend half the pass's exact-solve
        # budget: optimistic probes (soft constraints fully relaxed) can all
        # fail exact verification, and the single-node scan must still get
        # its turn before the pass is negative-cached
        prefix_budget = max(self.max_whatif_per_pass // 2, 1)

        # multi-node: largest probe-feasible prefix, verified by one exact
        # solve (the probe is optimistic — soft constraints fully relaxed).
        # A host-fallback set (outside the vmapped envelope) has no probe
        # verdict: it goes straight to the exact solve under the budget.
        for i in range(n_prefix - 1, -1, -1):
            removed = probe_sets[i]
            v = verdicts[i]
            if not v.host and not self._probe_ok(removed, v.probe,
                                                 v.removed_price):
                continue
            if not self._within_budgets(removed, "Underutilized"):
                continue  # budget can admit a smaller prefix — keep walking
            if self._whatif_used >= prefix_budget:
                # probe-positive prefixes remain unverified: the pass must
                # not be negative-cached on their account
                self._search_truncated = True
                break
            plan, removed_price = self._what_if(removed)
            ok = (not plan.unschedulable and len(plan.new_nodes) <= 1
                  and plan.new_node_cost < removed_price - CONSOLIDATION_SAVINGS_EPS
                  and self._spot_guard_ok(removed, plan))
            if ok:
                accepted, ratio = self.engine.referee(
                    removed, plan, node_by_claim=node_by_claim,
                    by_node=by_node)
                if not accepted:
                    # the device plan's costing disagrees with the host
                    # FFD oracle beyond the ≤2% envelope: a smaller
                    # prefix (or a single) may still referee clean
                    continue
                if self._begin("Underutilized", removed, plan,
                               max_replacement_cost=removed_price
                               - CONSOLIDATION_SAVINGS_EPS):
                    self.engine.note_accept(
                        removed, removed_price - plan.new_node_cost)
                    return True
                # _begin rejections surviving the budget pre-check (pool
                # limits, launch failure) are pass-invariant: stop paying
                # exact solves for smaller prefixes, leave budget for the
                # single-node scan
                break

        # single-node scan: only probe-positive candidates pay an exact
        # solve; bounded by the pass's remaining what-if budget
        truncated_at = None
        for j, claim in enumerate(singles):
            v = verdicts[n_prefix + j]
            node_name = node_by_claim[claim.name].name
            if not v.host and not self._probe_ok([claim], v.probe,
                                                 v.removed_price):
                # a probe-negative single IS the pass's answer for that
                # node — code it so `kpctl explain node` has one even when
                # the fleet is already tight (probes are optimistic, so a
                # probe-level "no savings" is conclusive, not provisional)
                if (v.probe.feasible and v.probe.n_new <= 1
                        and v.probe.new_cost
                        < v.removed_price - CONSOLIDATION_SAVINGS_EPS):
                    self.engine.note_skip(
                        node_name, taxonomy.CONSOLIDATION_SPOT_GUARD,
                        "spot replacement below the 15-type flexibility "
                        "floor or the spot-to-spot gate is off")
                else:
                    self.engine.note_skip(
                        node_name, taxonomy.CONSOLIDATION_NO_SAVINGS,
                        "probe: no repack within one replacement node "
                        f"cheaper than ${v.removed_price:.4f}/hr"
                        if not v.probe.feasible or v.probe.n_new > 1 else
                        f"probe: replacement ${v.probe.new_cost:.4f}/hr "
                        f"vs removed ${v.removed_price:.4f}/hr")
                continue
            if not self._within_budgets([claim], "Underutilized"):
                self.engine.note_skip(
                    node_name, taxonomy.NOT_CONSOLIDATABLE_BUDGET,
                    f"pool {claim.node_pool} disruption budget exhausted")
                continue
            if self._whatif_used >= self.max_whatif_per_pass:
                truncated_at = j
                break
            plan, removed_price = self._what_if([claim])
            if plan.unschedulable or len(plan.new_nodes) > 1:
                continue
            if plan.new_node_cost >= removed_price - CONSOLIDATION_SAVINGS_EPS:
                self.engine.note_skip(
                    node_name, taxonomy.CONSOLIDATION_NO_SAVINGS,
                    f"replacement ${plan.new_node_cost:.4f}/hr vs removed "
                    f"${removed_price:.4f}/hr")
                continue
            if not self._spot_guard_ok([claim], plan):
                self.engine.note_skip(
                    node_name, taxonomy.CONSOLIDATION_SPOT_GUARD,
                    "spot replacement below the 15-type flexibility floor "
                    "or the spot-to-spot gate is off")
                continue
            accepted, ratio = self.engine.referee(
                [claim], plan, node_by_claim=node_by_claim, by_node=by_node)
            if not accepted:
                self.engine.note_skip(
                    node_name, taxonomy.CONSOLIDATION_NO_SAVINGS,
                    f"device plan costs {ratio:.3f}x the host FFD referee "
                    f"(envelope 1.02)")
                continue
            if self._begin("Underutilized", [claim], plan,
                           max_replacement_cost=removed_price
                           - CONSOLIDATION_SAVINGS_EPS):
                self.engine.note_accept(
                    [claim], removed_price - plan.new_node_cost)
                return True
        # every single probed this pass is covered under the current
        # fingerprint (probe-negative IS an answer); candidates past a
        # budget truncation are not
        self._covered.update(
            c.name for c in (singles if truncated_at is None
                             else singles[:truncated_at]))
        if truncated_at is not None:
            # budget-truncated mid-window: resume exactly where the scan
            # stopped next pass (reconcile() skips the negative cache), and
            # always advance by >=1 so a deterministic repeat can't starve
            # the tail
            self._search_truncated = True
            self._scan_cursor = (start + max(truncated_at, 1)) % K
        elif self._whatif_used >= self.max_whatif_per_pass:
            # exhausted exactly at the window's end: next window
            self._search_truncated = True
            self._scan_cursor = (start + max(len(singles), 1)) % K
        elif len(singles) < K:
            # the window covered only part of the frontier even without
            # budget pressure (K > MAX_SINGLE_PROBES): advance so repeat
            # passes sweep the tail instead of deterministically
            # re-probing the same window — the coverage set keeps the
            # pass from negative-caching until the sweep completes
            self._scan_cursor = (start + len(singles)) % K
        else:
            self._scan_cursor = 0
        return False
