"""Provisioning controller: pending pods → Solve() → NodeClaims → launches.

Mirror of the core provisioner loop (reference: pending-pod watch → batch
window 1 s idle / 10 s max → scheduler simulation → NodeClaim create →
CloudProvider.Create; SURVEY.md §3.2, website reference/settings.md:17-18).
The FFD simulation is replaced by the device solver: cluster state renders
to tensors, the ICE cache masks the lattice, one Solve() packs the whole
batch, and the decoded NodePlan becomes NodeClaims. NodePool resource
limits are enforced host-side on the plan (nodepools.md limits), and
launch failures feed back via UnavailableOfferings for the next pass.
"""

from __future__ import annotations

import itertools
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import trace
from ..apis import wellknown as wk
from ..apis.objects import NodeClaim, NodeClaimPhase, NodePool, Pod
from ..apis.requirements import Operator, Requirement
from ..apis.resources import R, axis as res_axis, resources_to_vec
from ..cache.unavailable import UnavailableOfferings
from ..cloudprovider.cloudprovider import CloudProvider
from ..errors import UnfulfillableCapacityError
from ..events import Recorder
from ..lattice.tensors import Lattice, masked_view_versioned
from ..metrics import Registry, wire_core_metrics
from ..solver import explain as explain_mod
from ..solver import taxonomy
from ..solver.explain import DecisionAuditRing
from ..solver.solve import NodePlan, PlannedNode, Solver
from ..state.cluster import ClusterState
from ..utils.clock import Clock

BATCH_IDLE_SECONDS = 1.0   # settings.md:17 batch-idle-duration (default)
BATCH_MAX_SECONDS = 10.0   # settings.md:18 batch-max-duration (default)
_PODS_AXIS = res_axis("pods")

# Bumped whenever the nodepool_hash PAYLOAD SHAPE changes (e.g. the
# kubelet block joining it): claims stamped under an older version are
# RE-STAMPED instead of drift-compared, so a controller upgrade never
# rolls the whole fleet (the reference migrates its hash the same way —
# wellknown ANNOTATION_NODEPOOL_HASH_VERSION).
NODEPOOL_HASH_VERSION = "v5"  # v5: slice fields hash as SETS (+ startupTaints in v4)


def nodepool_hash(pool: NodePool) -> str:
    """Template hash for NodePool drift detection (the core's
    karpenter.sh/nodepool-hash annotation; CRD nodepools drift semantics).
    Every field stamped onto launched nodes participates; fields that
    only steer the SOLVE (weight, limits, the disruption block) stay
    out — retuning them must never roll the fleet. Slice fields hash
    ORDER-INSENSITIVELY (the reference's hashstructure SlicesAsSets):
    reordering semantically-identical taints/requirements in YAML must
    never roll a fleet."""
    import hashlib
    import json
    payload = json.dumps({
        "labels": sorted(pool.labels.items()),
        "annotations": sorted(pool.annotations.items()),
        # kubelet knobs are template spec: changing maxPods or clusterDNS
        # must drift (and roll) nodes launched with the old values
        "kubelet": ((pool.kubelet.max_pods, pool.kubelet.cluster_dns)
                    if pool.kubelet is not None else None),
        "taints": sorted((t.key, t.value or "", t.effect)
                         for t in pool.taints),
        # startupTaints shape the node exactly like taints do (the init
        # daemon contract changes with them); the reference hashes them
        "startup_taints": sorted((t.key, t.value or "", t.effect)
                                 for t in pool.startup_taints),
        "requirements": sorted((r.key, r.operator.value,
                                sorted(str(v) for v in r.values))
                               for r in pool.requirements),
        "node_class_ref": pool.node_class_ref,
    }, sort_keys=True, default=str)
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


@dataclass
class ProvisionResult:
    plan: Optional[NodePlan]
    created_claims: List[NodeClaim] = field(default_factory=list)
    launched: int = 0
    launch_failures: int = 0
    pods_scheduled: int = 0
    pods_unschedulable: int = 0
    # degradation provenance of the pass (docs/concepts/degradation.md):
    # True when any solve left the primary device path, or when the solve
    # itself failed and the pass returned a PARTIAL result (pods stay
    # pending for the next pass instead of the wave being dropped)
    degraded: bool = False
    degraded_reason: str = ""


class Provisioner:
    def __init__(self, cluster: ClusterState, solver: Solver,
                 node_pools: Dict[str, NodePool],
                 cloud_provider: CloudProvider,
                 unavailable: UnavailableOfferings,
                 recorder: Optional[Recorder] = None,
                 clock: Optional[Clock] = None,
                 batch_idle_seconds: float = BATCH_IDLE_SECONDS,
                 batch_max_seconds: float = BATCH_MAX_SECONDS,
                 metrics: Optional[Registry] = None,
                 writer=None, slo=None):
        self.cluster = cluster
        self.solver = solver
        self.node_pools = node_pools
        self.cloud_provider = cloud_provider
        self.unavailable = unavailable
        self.clock = clock or Clock()
        from ..kube.writer import DirectWriter
        # every k8s-object write goes through the writer seam: direct to
        # the mirror (simulation stratum) or through the apiserver client
        # (kube/writer.py ApiWriter)
        self.writer = writer or DirectWriter(cluster, self.clock)
        self.recorder = recorder or Recorder(self.clock)
        self.batch_idle_seconds = batch_idle_seconds
        self.batch_max_seconds = batch_max_seconds
        from ..solver.incremental import IncrementalProblemBuilder
        # the steady-state incremental path: one builder per provisioner
        # retains the previous pass's Problem keyed at the cluster-state
        # revision; eligible small-churn passes delta-solve instead of
        # re-tensorizing from scratch (docs/concepts/performance.md
        # "Steady-state reconciles & the compile cache")
        self.inc_builder = IncrementalProblemBuilder()
        self._delta_enabled = bool(getattr(solver, "supports_delta", False))
        from ..state.cluster import DirtyJournalCoalescer
        # journal → device-block coalescer (docs/reference/microloop.md):
        # batch-window polls drain the dirty journal incrementally, so a
        # pass starts from an already-merged delta covering every tick
        # since the last build instead of one long locked journal walk
        self.journal_coalescer = DirtyJournalCoalescer(cluster)
        m = wire_core_metrics(metrics or Registry())  # single source of truth
        self._m_sched = m["scheduling_duration"]
        self._m_sim = m["scheduling_simulation_duration"]
        self._m_batch = m["batch_size"]
        self._m_sched_pods = m["pods_scheduled"]
        self._m_unsched_pods = m["pods_unschedulable"]
        self._m_created = m["nodeclaims_created"]
        self._m_launched = m["nodeclaims_launched"]
        self._m_degraded = m["solver_degraded"]
        self._m_solver_retries = m["solver_device_retries"]
        self._m_waves = m["solver_waves"]
        self._m_stage = m["solver_stage_duration"]
        self._m_delta = m["solver_delta_solves"]
        self._m_dirty_groups = m["solver_dirty_groups"]
        self._m_link_legs = m["solver_link_legs"]
        self._m_link_bytes = m["solver_link_bytes"]
        # last mirrored solver link_stats values (the counters are
        # cumulative on the Solver; the metric counters inc by delta)
        self._link_prev: Dict[str, int] = {}
        self._m_pods_state = m["pods_state"]
        self._m_unsched_reasons = m["pods_unschedulable_reasons"]
        self._m_eliminations = m["explain_eliminations"]
        # SLO burn tracking (introspect/slo.py): every pass records its
        # end-to-end solve latency; a sampled FFD-referee re-pack records
        # the cost ratio. None = untracked (bare Provisioner in tests).
        self.slo = slo
        self._claim_ids = itertools.count(1)
        # the decision-audit ring (solver/explain.py): one explanation
        # per pass, served via /debug/explain + `kpctl explain`; the
        # operator registers .stats as the "explain" provider
        self.explain = DecisionAuditRing()
        self._pass_seq = itertools.count(1)
        # FailedScheduling dedup: pod -> (last published reason CODE,
        # the Pod OBJECT it was published for). A stuck pod publishes
        # ONCE per (pod, reason-code); the entry re-arms when the
        # reason changes, the pod makes progress (binds, or is deleted
        # — it leaves the unschedulable set), or the NAME is reused by
        # a recreated pod (cluster state hands the same object every
        # pass, so a new object under an old name is a new pod and its
        # failure deserves its own event)
        self._failed_pub: Dict[str, Tuple[str, object]] = {}
        self._batch_start: Optional[float] = None
        self._last_pod_seen: Optional[float] = None
        self._known_pending: frozenset = frozenset()
        self._lock = threading.Lock()
        # introspection: pass counters + the last pass's outcome
        self.passes = 0
        self._last_pass: Dict[str, float] = {}

    # ---- batch window (settings.md:17-18) --------------------------------

    def batch_ready(self) -> bool:
        """Has the pending-pod batch window closed? New arrivals reset the
        idle timer; the max window bounds total latency. Arrival detection
        compares the pending-pod NAME set, not its size — one pod binding
        while another arrives in the same window is still an arrival.

        Every poll also streams the dirty journal into the coalescer:
        the open batch window is exactly when the controller is "behind"
        on ticks, and draining here keeps the pass-start journal walk
        O(since last poll) instead of O(since last pass)."""
        if self._delta_enabled:
            self.journal_coalescer.tick(self.inc_builder.rev)
        now = self.clock.now()
        with self._lock:
            names = frozenset(p.name for p in self.cluster.pending_pods())
            if not names:
                self._batch_start = None
                self._last_pod_seen = None
                self._known_pending = frozenset()
                return False
            if self._batch_start is None:
                self._batch_start = now
                self._last_pod_seen = now
                self._known_pending = names
                return False
            if names - self._known_pending:
                self._last_pod_seen = now
            self._known_pending = names
            idle_over = now - self._last_pod_seen >= self.batch_idle_seconds
            max_over = now - self._batch_start >= self.batch_max_seconds
            if idle_over or max_over:
                self._batch_start = None
                self._last_pod_seen = None
                self._known_pending = frozenset()
                return True
            return False

    # ---- one scheduling pass --------------------------------------------

    @staticmethod
    def _batch_trace_context(pending: Sequence[Pod]):
        """(parent, links) for the pass span. Pods created through the
        REST surface carry the admission span's traceparent as an
        annotation (kube/httpserver.py); the pass — which coalesced many
        pods behind the batch window — JOINS the first such trace and
        LINKS the rest, so one REST write's trace reaches all the way to
        the device solve while the other writes stay causally attached."""
        ctxs = []
        for p in pending:
            tp = p.annotations.get(wk.ANNOTATION_TRACEPARENT)
            if tp:
                ctxs.append(tp)
        return (ctxs[0] if ctxs else None), ctxs[1:]

    def provision_once(self) -> ProvisionResult:
        # the revision is read BEFORE the pending snapshot: the build is
        # keyed at rev0, so any mutation racing the snapshot (threaded
        # stratum) lands at a rev > rev0 and is re-examined by the next
        # pass's dirty read instead of silently falling between passes
        rev0 = self.cluster.state_rev
        pending = self.cluster.pending_pods()
        if not pending:
            return ProvisionResult(plan=None)
        parent, links = (self._batch_trace_context(pending)
                         if trace.enabled() else (None, ()))
        with trace.span("provisioner.provision", parent=parent, links=links,
                        pods=len(pending)) as sp:
            result = self._provision(pending, rev0)
            sp.set(degraded=result.degraded,
                   reason=result.degraded_reason,
                   launched=result.launched,
                   scheduled=result.pods_scheduled,
                   unschedulable=result.pods_unschedulable)
            return result

    def warm_build(self, solve: bool = False) -> bool:
        """Standby pre-build (state/replication.py StandbyReplica): run
        the pass's problem build — and optionally a PURE solve — over
        the replicated mirror WITHOUT dispatching a single write. The
        resident device problem and the persistent compile cache warm up
        exactly as a real pass would, so the first post-promotion pass
        is a delta, not a compile storm. Returns True when a problem was
        built."""
        lattice = masked_view_versioned(self.solver.lattice, self.unavailable)
        pvcs, storage_classes = self.cluster.volume_state()
        headroom = self._pool_headroom(self.cluster.pool_usage())
        pools = list(self.node_pools.values())
        pending = self.cluster.pending_pods()
        dirty = self.journal_coalescer.take(self.inc_builder.rev)
        touched = (self.cluster.touched_pods(dirty.pods)
                   if dirty.pods and not dirty.full else {})
        build = self.inc_builder.build(
            pending, pools, lattice,
            existing=lambda: self.cluster.existing_bins(lattice),
            daemonset_pods=self.cluster.daemonset_pods,
            bound_pods=self.cluster.bound_pods,
            pvcs=pvcs, storage_classes=storage_classes,
            pool_headroom=headroom, dirty=dirty, touched=touched)
        if solve and pending:
            # solve_relaxed is side-effect free: plans are computed, never
            # acted on — this is compile/trace warmth only
            self.solver.solve_relaxed(
                pending, pools, lattice,
                existing=self.cluster.existing_bins(lattice),
                daemonset_pods=self.cluster.daemonset_pods(),
                bound_pods=self.cluster.bound_pods(),
                pvcs=pvcs, storage_classes=storage_classes,
                pool_headroom=headroom, problem0=build.problem)
        return build.problem is not None

    def _provision(self, pending: Sequence[Pod],
                   rev0: Optional[int] = None) -> ProvisionResult:
        # versioned memo: the SAME view object comes back while prices and
        # the ICE set are unchanged, so the solver's identity-keyed
        # narrowing cache hits across steady-state passes
        lattice = masked_view_versioned(self.solver.lattice, self.unavailable)
        pvcs, storage_classes = self.cluster.volume_state()
        # one usage snapshot serves the whole pass: the initial solve's
        # headroom, every _enforce_limits round, and every retry's headroom
        pass_usage = self.cluster.pool_usage()
        headroom = self._pool_headroom(pass_usage)
        pools = list(self.node_pools.values())
        # memoized thunks: the O(pods) cluster scans resolve at most once
        # per pass, and NOT AT ALL when the incremental builder proves
        # from the dirty journal that their inputs did not change
        resolved: Dict[str, object] = {}

        def _existing():
            if "existing" not in resolved:
                resolved["existing"] = self.cluster.existing_bins(lattice)
            return resolved["existing"]

        def _ds():
            if "ds" not in resolved:
                resolved["ds"] = self.cluster.daemonset_pods()
            return resolved["ds"]

        def _bound():
            if "bound" not in resolved:
                resolved["bound"] = self.cluster.bound_pods()
            return resolved["bound"]

        problem0 = None   # the round-0 problem (carries the ledgers)
        batched = [False]   # overlap seam fired (observation staged)?
        try:
            if self._delta_enabled:
                # the coalescer already merged every journal tick since
                # the last build (batch_ready polls drain it); take() is
                # one short drain, not the whole backlog
                dirty = self.journal_coalescer.take(self.inc_builder.rev)
                if rev0 is not None:
                    # key the build at the pre-snapshot revision: journal
                    # entries racing the pending snapshot stay > rev0 and
                    # are re-read (idempotently) next pass
                    dirty.rev = rev0
                touched = (self.cluster.touched_pods(dirty.pods)
                           if dirty.pods and not dirty.full else {})
                build = self.inc_builder.build(
                    pending, pools, lattice, existing=_existing,
                    daemonset_pods=_ds, bound_pods=_bound, pvcs=pvcs,
                    storage_classes=storage_classes,
                    pool_headroom=headroom, dirty=dirty, touched=touched)
                problem0 = build.problem
                if build.incremental:
                    # the steady-state fast path: patched problem, the
                    # device-resident microloop, dirty blocks only over
                    # the link. Admission bookkeeping rides the in-
                    # flight dispatch through the overlap seam instead
                    # of serializing behind the solve.
                    # the seam only STAGES the observation — the commit
                    # happens after the solve lands, so a pass whose
                    # dispatch fired the seam but then dropped its wave
                    # (post-dispatch device fault + fallback failure)
                    # never skews the admission histograms
                    def _admission_overlap():
                        batched[0] = True
                    plan = self.solver.solve_delta(
                        build.problem, dirty_groups=build.dirty_groups,
                        overlap=_admission_overlap)
                    self._m_delta.inc()
                else:
                    # full path; round 0 reuses the problem already built
                    plan = self.solver.solve_relaxed(
                        pending, pools, lattice, existing=_existing(),
                        daemonset_pods=_ds(), bound_pods=_bound(),
                        pvcs=pvcs, storage_classes=storage_classes,
                        pool_headroom=headroom, problem0=build.problem)
            else:
                plan = self.solver.solve_relaxed(
                    pending, pools, lattice, existing=_existing(),
                    daemonset_pods=_ds(), bound_pods=_bound(),
                    pvcs=pvcs, storage_classes=storage_classes,
                    pool_headroom=headroom)
        except Exception as e:
            # the solve ladder already absorbs device failures; anything
            # that still escapes must not kill the reconcile loop. Report a
            # PARTIAL (empty) result — the pods stay pending and the next
            # pass retries — instead of dropping the wave with a crash.
            return self._solve_failed(e, len(pending))
        # admission metrics commit only for a LANDED wave (a failed pass
        # returned above) — the staged overlap observation included
        self._m_batch.observe(len(pending))
        if batched[0]:
            self._m_dirty_groups.observe(len(build.dirty_groups))
        self._m_sched.observe(plan.solve_seconds)
        self._m_sim.observe(plan.device_seconds)
        self._mirror_link_metrics()
        if self.slo is not None:
            # the rolling latency window behind
            # karpenter_slo_latency_budget_burn; the cost referee is
            # cadence-gated inside the tracker (a host FFD re-pack of
            # the SAME inputs, never on every pass). The same inputs are
            # the pass's memoized snapshots: other controllers change the
            # cluster while this pass solves, and a re-read after the
            # solve (as the JAX package does) can see capacity the solve
            # never saw, which reads as a costlier plan than FFD's
            self.slo.record_latency(plan.solve_seconds)

            def _referee_problem():
                from ..solver.problem import build_problem
                return build_problem(
                    list(pending), list(self.node_pools.values()), lattice,
                    existing=_existing(), daemonset_pods=_ds(),
                    bound_pods=_bound(), pvcs=pvcs,
                    storage_classes=storage_classes, pool_headroom=headroom)
            self.slo.maybe_cost_referee(plan, _referee_problem)
        result = ProvisionResult(plan=plan)
        self._observe_solver_health(plan, result)

        # the pass explanation: ledgers from the round-0 problem + the
        # plan's outcome; limit-fallback drops and claim rationale fold
        # in below, and the finished record lands in the audit ring at
        # pass end. RemoteSolver passes (no local problem) still record
        # outcome + reason codes, just without the waterfall.
        sp_now = trace.current()
        expl = explain_mod.explain_pass(
            problem0, plan, next(self._pass_seq),
            sp_now.trace_id if sp_now is not None else "",
            self.clock.now())
        # every unschedulable reason seen THIS pass (all plans + limit
        # drops): the dedup map re-arms from it at pass end
        seen_unsched: Dict[str, str] = {}
        pod_by_name: Dict[str, Pod] = {}

        def surface_unschedulable(p: NodePlan, first: bool = False) -> None:
            if p.unschedulable and not pod_by_name:
                # built only when a pass actually has unschedulable pods
                pod_by_name.update({q.name: q for q in pending})
            for name, reason in p.unschedulable.items():
                self._publish_failed(name, reason, seen_unsched,
                                     pod=pod_by_name.get(name))
                if not first:
                    explain_mod.add_unschedulable(expl, name, reason)
            result.pods_unschedulable += len(p.unschedulable)

        def bind_existing(p: NodePlan) -> None:
            # pods that fit existing capacity bind (in the real control
            # plane the kube-scheduler binds; the sim binds directly,
            # reference stratum-2). The whole plan's binds go as ONE
            # batched write (writer.bind_pods → the apiserver bulk
            # verb): bind_pod was the profiled #1 write-path frame,
            # paying lock + fan-out per pod.
            to_bind: List[Tuple[str, str]] = []
            for node_name, pods in p.existing_assignments.items():
                target_is_claim = (node_name in self.cluster.claims
                                   and node_name not in self.cluster.nodes)
                for pn in pods:
                    if target_is_claim:
                        # nominations count at decision time — a pod
                        # deleted before the claim registers drops out
                        # of nominated_pods() and is simply never bound
                        self.cluster.nominate(pn, node_name)
                        result.pods_scheduled += 1
                    else:
                        to_bind.append((pn, node_name))
            if to_bind:
                # raced binds (pod evicted/deleted under us in threaded
                # API mode) report False and don't count as scheduled
                result.pods_scheduled += sum(self.writer.bind_pods(to_bind))

        surface_unschedulable(plan, first=True)
        bind_existing(plan)

        # limits + fallback (scheduling.md:488): a node the pool's limits
        # cannot hold re-solves its pods against the remaining pools —
        # the reserved-capacity pattern (high-weight limited pool fills
        # first, overflow lands on the generic pool). The loop terminates:
        # each retry excludes at least one more saturated pool.
        planned: List[PlannedNode] = []
        # each planned node remembers the PLAN that produced it (the
        # limit-fallback loop can mix plans in one pass), so its claim is
        # stamped with the right solve's provenance annotations
        prov_by_node: Dict[int, Dict[str, str]] = {}
        current = plan
        excluded: set = set()
        for _ in range(len(self.node_pools) + 1):
            fitting, dropped = self._enforce_limits(current.new_nodes,
                                                    usage=pass_usage)
            planned += fitting
            prov = self._provenance_annotations(current)
            for n in fitting:
                prov_by_node[id(n)] = prov
            if not dropped:
                break
            excluded |= {n.node_pool for n in dropped}
            pools_left = [p for p in self.node_pools.values()
                          if p.name not in excluded]
            retry_pods = [self.cluster.pods[pn] for n in dropped
                          for pn in n.pods if pn in self.cluster.pods]
            if not pools_left or not retry_pods:
                for n in dropped:
                    live = [pn for pn in n.pods if pn in self.cluster.pods]
                    msg = taxonomy.reason(
                        taxonomy.POOL_LIMITS,
                        f"nodepool {n.node_pool} limit exceeded")
                    for pn in live:
                        self._publish_failed(pn, msg, seen_unsched,
                                             pod=self.cluster.pods.get(pn))
                        explain_mod.add_unschedulable(expl, pn, msg)
                    result.pods_unschedulable += len(live)
                break
            try:
                current = self.solver.solve_relaxed(
                    retry_pods, pools_left, lattice,
                    existing=self.cluster.existing_bins(lattice),
                    daemonset_pods=self.cluster.daemonset_pods(),
                    bound_pods=self.cluster.bound_pods(),
                    pvcs=pvcs, storage_classes=storage_classes,
                    pool_headroom=self._pool_headroom(pass_usage))
            except Exception as e:
                # a failed limit-fallback re-solve degrades to a partial
                # pass: keep everything already planned/bound, leave the
                # retry pods pending for the next pass
                self._note_solve_failure(e, result)
                break
            self._observe_solver_health(current, result)
            surface_unschedulable(current)
            bind_existing(current)
            # retry-round existing-capacity placements reach the audit
            # ring too (round 0's came in with explain_pass)
            explain_mod.add_placements(expl, current)
        for node in planned:
            claim = self._make_claim(node)
            claim.annotations.update(prov_by_node.get(id(node), {}))
            self.writer.create_claim(claim)
            self._m_created.inc(nodepool=claim.node_pool)
            result.created_claims.append(claim)
            for p in node.pods:
                self.cluster.nominate(p, claim.name)
            try:
                self.cloud_provider.create(claim)
                # write the launch results (providerID/type/zone/phase)
                # back through the seam — the reference's status update
                self.writer.update_claim_status(claim)
                self._m_launched.inc(nodepool=claim.node_pool)
                result.launched += 1
                result.pods_scheduled += len(node.pods)
                # the launch fixed the zone: bind nominated pods' unbound
                # claims NOW so a cross-batch consumer arriving before the
                # node registers already sees the pinned zone
                for p in node.pods:
                    self.writer.bind_volumes(p, claim.zone)
                self.recorder.publish("Normal", "Launched", "NodeClaim", claim.name,
                                      f"{claim.instance_type}/{claim.zone}/{claim.capacity_type} "
                                      f"for {len(node.pods)} pod(s)")
                # placement rationale (chosen offering, runner-up type +
                # price delta) for `kpctl explain nodeclaim`
                explain_mod.add_claim(expl, claim.name, node,
                                      runner_up=self._runner_up(node))
            except UnfulfillableCapacityError:
                # offerings already marked unavailable by the provider; the
                # pods return to pending and the next pass re-solves with the
                # tightened ICE mask (instance.go:348-354 feedback loop)
                result.launch_failures += 1
                self.writer.rollback_claim(claim.name)
                result.created_claims.pop()
            except Exception as e:
                # a reconcile loop must survive any launch failure
                # (misconfigured NodeClass, transient API error): roll the
                # claim back, surface the cause, keep launching the rest
                result.launch_failures += 1
                self.recorder.publish("Warning", "LaunchFailed", "NodeClaim",
                                      claim.name, f"{type(e).__name__}: {e}")
                self.writer.rollback_claim(claim.name)
                result.created_claims.pop()
        self._m_sched_pods.inc(result.pods_scheduled)
        self._m_unsched_pods.set(result.pods_unschedulable)
        # the explain surfaces: reason-code counters (rate-able per
        # pass, like FailedScheduling events pre-dedup), per-stage
        # elimination counters, and the audit-ring record
        for code, n in expl.reason_counts.items():
            self._m_unsched_reasons.inc(n, code=code)
        for stage, n in expl.eliminations.items():
            self._m_eliminations.inc(n, stage=stage)
        self.explain.record(expl)
        self._finish_pass(result, len(pending),
                          solve_ms=plan.solve_seconds * 1000.0,
                          seen_unsched=seen_unsched)
        return result

    def _publish_failed(self, name: str, reason: str,
                        seen: Dict[str, str], pod=None) -> None:
        """Publish FailedScheduling deduped per (pod, reason-code): the
        same stuck pod re-surfacing with the same code on every pass
        publishes ONCE; a changed code, a renewed failure after
        progress, or a same-name RECREATED pod (different object — see
        _failed_pub) re-publishes. ``seen`` collects this pass's
        unschedulable set for the re-arm sweep in _finish_pass."""
        seen[name] = reason
        code = taxonomy.code_of(reason)
        prev = self._failed_pub.get(name)
        if prev is not None and prev[0] == code \
                and (pod is None or prev[1] is pod):
            return
        self._failed_pub[name] = (code, pod)
        self.recorder.publish("Warning", "FailedScheduling", "Pod",
                              name, reason)

    def _runner_up(self, node: PlannedNode):
        """(type, cheapest offering price) of the bin's second-cheapest
        feasible type — the price delta `kpctl explain nodeclaim`
        renders next to the chosen offering. Priced against the MASKED
        lattice (the one the pass solved against): an ICE'd-out
        offering must never present as the viable alternative. None
        when the bin had no (currently available) flexibility."""
        alts = [t for t in node.feasible_types if t != node.instance_type]
        if not alts:
            return None
        import dataclasses
        probe = dataclasses.replace(node, instance_type=alts[0], pods=[])
        price = self._offering_price(
            probe, lat=masked_view_versioned(self.solver.lattice,
                                             self.unavailable))
        return (alts[0], price) if np.isfinite(price) else None

    def _finish_pass(self, result: ProvisionResult, n_pending: int,
                     solve_ms: float = 0.0,
                     seen_unsched: Optional[Dict[str, str]] = None) -> None:
        """End-of-pass bookkeeping: the pods_state gauge re-renders from
        the mirror (binds/nominations just changed the phase split) and
        the introspection record captures the pass's outcome."""
        counts = self.cluster.pod_phase_counts()
        self._m_pods_state.replace({(k,): float(v)
                                    for k, v in counts.items()})
        if seen_unsched is not None:
            # re-arm the FailedScheduling dedup for pods that made
            # progress: anything no longer unschedulable this pass
            # (bound, nominated, deleted) drops out, so a LATER failure
            # publishes again. A solve-error pass passes None — the
            # batch never got examined, nothing re-arms.
            for gone in [n for n in self._failed_pub
                         if n not in seen_unsched]:
                del self._failed_pub[gone]
        with self._lock:
            self.passes += 1
            self._last_pass = {
                "t": round(self.clock.now(), 3),
                "pods": n_pending,
                "launched": result.launched,
                "scheduled": result.pods_scheduled,
                "unschedulable": result.pods_unschedulable,
                "degraded": 1.0 if result.degraded else 0.0,
                "solve_ms": round(solve_ms, 3),
            }

    def stats(self) -> Dict[str, float]:
        """Introspection provider: batch-window occupancy + solver
        cadence (what `kpctl top`'s BATCH/SOLVER rows render)."""
        now = self.clock.now()
        with self._lock:
            out: Dict[str, float] = {
                "batch_pending": len(self._known_pending),
                "batch_age_seconds": (round(now - self._batch_start, 3)
                                      if self._batch_start is not None
                                      else 0.0),
                "passes": self.passes,
                # the incremental problem builder's build split
                # (solver/incremental.py; the delta-SOLVE counters ride
                # the solver provider)
                "incremental_builds": self.inc_builder.incremental_builds,
                "full_builds": self.inc_builder.full_builds,
                # journal → device-block coalescer activity (state/
                # cluster.py DirtyJournalCoalescer): batch-window drains,
                # pass-start takes, and anchor-mismatch fallbacks
                "journal_ticks": self.journal_coalescer.ticks,
                "journal_takes": self.journal_coalescer.takes,
                "journal_take_fallbacks": self.journal_coalescer.fallbacks,
            }
            out.update({"last_pass_" + k: v
                        for k, v in self._last_pass.items()})
        return out

    def _mirror_link_metrics(self) -> None:
        """Mirror the solver's cumulative link accounting into the
        karpenter_solver_link_legs_total / _link_bytes_total counters
        (per-pass delta inc — the solver counts transfers, the metric
        registry owns exposition). A solver without link accounting
        (RemoteSolver, SolverPool) simply never moves these."""
        ls = getattr(self.solver, "link_stats", None)
        if not ls:
            return
        for direction in ("upload", "fetch"):
            for kind, metric in (("legs", self._m_link_legs),
                                 ("bytes", self._m_link_bytes)):
                k = f"{direction}_{kind}"
                cur = int(ls.get(k, 0))
                d = cur - self._link_prev.get(k, 0)
                if d > 0:
                    metric.inc(d, direction=direction)
                self._link_prev[k] = cur

    # ---- degradation observation (docs/concepts/degradation.md) ----------

    def _provenance_annotations(self, plan: NodePlan) -> Dict[str, str]:
        """Solver provenance for a claim's annotations — the wire-visible
        record of WHY this claim's solve was slow or degraded, which
        `kpctl describe nodeclaims` renders for operators. The pass
        span's traceparent rides along so a claim points straight at its
        flight-recorder trace (and NodeClaim registration joins it)."""
        import json as _json
        ann = {
            wk.ANNOTATION_SOLVER_PATH: plan.solver_path,
            wk.ANNOTATION_SOLVER_PIPELINED:
                "true" if plan.pipelined else "false",
            wk.ANNOTATION_SOLVER_WAVES: str(plan.waves),
        }
        if getattr(plan, "mesh_devices", 1) > 1:
            # the sharded production path: which mesh packed this claim
            # (absent = single-device; kpctl describe renders the row)
            ann[wk.ANNOTATION_SOLVER_MESH_DEVICES] = str(plan.mesh_devices)
        if plan.degraded_reason:
            ann[wk.ANNOTATION_SOLVER_DEGRADED_REASON] = plan.degraded_reason
        if plan.stage_ms:
            ann[wk.ANNOTATION_SOLVER_STAGE_MS] = _json.dumps(
                {k: round(float(v), 3) for k, v in plan.stage_ms.items()},
                sort_keys=True, separators=(",", ":"))
        tp = trace.capture()
        if tp:
            ann[wk.ANNOTATION_TRACEPARENT] = tp
        return ann

    def _observe_solver_health(self, plan: NodePlan,
                               result: ProvisionResult) -> None:
        """Mirror a plan's degradation provenance into the metric surface
        and the event stream — the operator-facing signal that the solve
        left the primary device path."""
        if plan.device_retries:
            self._m_solver_retries.inc(plan.device_retries)
        self._m_waves.observe(plan.waves)
        # per-stage timings (seconds, like every duration series): the
        # overlap evidence — on a pipelined solve "download" is only the
        # residual wait after prefetch/decode-prep ran inside the window.
        # The ambient pass span's trace id rides as an EXEMPLAR, so a
        # dashboard's slow histogram bucket links to a concrete retained
        # trace (`kpctl trace export <id>`).
        sp = trace.current()
        exemplar = sp.trace_id if sp is not None else None
        for stage, ms in plan.stage_ms.items():
            self._m_stage.observe(ms / 1000.0, exemplar=exemplar,
                                  stage=stage)
        if plan.degraded:
            reason = plan.degraded_reason or "unknown"
            self._m_degraded.inc(path=plan.solver_path, reason=reason)
            result.degraded = True
            result.degraded_reason = result.degraded_reason or reason
            self.recorder.publish(
                "Warning", "SolverDegraded", "Provisioner", "default",
                f"solve degraded to {plan.solver_path} ({reason}, "
                f"{plan.waves} wave(s))")

    def _note_solve_failure(self, e: Exception,
                            result: ProvisionResult) -> None:
        self._m_degraded.inc(path="none", reason="solve-error")
        result.degraded = True
        result.degraded_reason = result.degraded_reason or "solve-error"
        self.recorder.publish("Warning", "SolverFailed", "Provisioner",
                              "default", f"{type(e).__name__}: {e}")

    def _solve_failed(self, e: Exception, n_pending: int) -> ProvisionResult:
        result = ProvisionResult(plan=None)
        self._note_solve_failure(e, result)
        # the early return skips the end-of-pass gauge update: reflect the
        # whole stuck batch as unschedulable so dashboards show the outage's
        # blast radius instead of freezing at the previous pass's value
        result.pods_unschedulable = n_pending
        self._m_unsched_pods.set(n_pending)
        # the audit ring records the outage pass too: the whole batch is
        # pending for reason solve-error (partial-result guard), so
        # `kpctl explain pass` answers "why is everything stuck" during
        # a solver outage
        sp_now = trace.current()
        expl = explain_mod.PassExplanation(
            pass_id=next(self._pass_seq),
            trace_id=sp_now.trace_id if sp_now is not None else "",
            t=self.clock.now(), pods=n_pending,
            note=f"solve failed: {type(e).__name__}: {e}")
        expl.unschedulable_total = n_pending
        expl.reason_counts[taxonomy.SOLVE_ERROR] = n_pending
        self._m_unsched_reasons.inc(n_pending, code=taxonomy.SOLVE_ERROR)
        self.explain.record(expl)
        self._finish_pass(result, n_pending)
        return result

    @staticmethod
    def _remaining(pool: NodePool, current: np.ndarray) -> Optional[np.ndarray]:
        """The pool's remaining limit budget per axis: limit - current on
        every axis the pool names (an explicit 0 is the standard
        pause-this-pool pattern and must block), np.inf elsewhere. The
        single source of the limited-axes semantics — both the solve-time
        headroom mask and _enforce_limits consume it."""
        limit = pool.limits_vec()
        if limit is None:
            return None
        rem = np.full((R,), np.inf, np.float32)
        for key in pool.limits:
            try:
                ax = res_axis(key)
            except KeyError:
                continue
            rem[ax] = max(limit[ax] - current[ax], 0.0)
        return rem

    def _pool_headroom(self, usage: Dict[str, np.ndarray]
                       ) -> Dict[str, np.ndarray]:
        """Per limited pool: remaining capacity budget (see _remaining).
        Fed into the solve so a fresh node's type options shrink as the
        pool approaches spec.limits — the reference caps its in-flight
        simulated nodes the same way, which is what lets a limited pool
        fill partially instead of all-or-nothing."""
        zeros = np.zeros((R,), np.float32)
        out: Dict[str, np.ndarray] = {}
        for name, pool in self.node_pools.items():
            rem = self._remaining(pool, usage.get(name, zeros))
            if rem is not None:
                out[name] = rem
        return out

    def _offering_price(self, node: PlannedNode,
                        lat: Optional[Lattice] = None) -> float:
        """Cheapest available offering price for the node's instance type
        within its feasible zone/capacity-type sets (``lat`` overrides
        the base lattice — the runner-up rationale prices against the
        ICE-masked view)."""
        lat = lat if lat is not None else self.solver.lattice
        ti = lat.name_to_idx.get(node.instance_type)
        if ti is None:
            return float("inf")
        zs = [lat.zones.index(z) for z in (node.feasible_zones or lat.zones)
              if z in lat.zones]
        cs = [lat.capacity_types.index(c)
              for c in (node.feasible_capacity_types or lat.capacity_types)
              if c in lat.capacity_types]
        if not zs or not cs:
            return float("inf")
        sub = np.where(lat.available[np.ix_([ti], zs, cs)],
                       lat.price[np.ix_([ti], zs, cs)], np.inf)
        return float(sub.min())

    def _enforce_limits(self, nodes: Sequence[PlannedNode],
                        usage: Optional[Dict[str, np.ndarray]] = None,
                        ) -> Tuple[List[PlannedNode], List[PlannedNode]]:
        """Enforce NodePool resource limits on the plan (CRD nodepools
        limits). A violating node first tries to DOWNSIZE: every type in the
        bin's feasible set can hold the bin's pods by construction, so the
        cheapest one whose capacity fits the remaining budget substitutes.
        Returns (fitting nodes, dropped nodes) — the caller decides whether
        dropped pods retry against other pools (the scheduling.md:488
        Fallback pattern) or surface as unschedulable.

        ``usage`` carries committed capacity ACROSS calls: the fallback
        loop passes one dict for the whole pass so nodes accepted in an
        earlier retry round keep counting against their pool's limit
        (cluster state alone misses them — their claims are only created
        after the loop)."""
        if usage is None:
            usage = self.cluster.pool_usage()
        out: List[PlannedNode] = []
        dropped: List[PlannedNode] = []
        lat = self.solver.lattice
        for node in nodes:
            pool = self.node_pools.get(node.node_pool)
            limit = pool.limits_vec() if pool is not None else None
            if limit is None:
                out.append(node)
                continue
            current = usage.get(node.node_pool, np.zeros((R,), np.float32))
            remaining = self._remaining(pool, current)
            kub = pool.kubelet

            def node_capacity(tname: str) -> np.ndarray:
                """What the launched node will actually charge against
                the pool's limits — the kubelet maxPods clamp applies at
                create, so limit accounting must see the clamped value
                (pool_usage later charges exactly this)."""
                cap = lat.capacity[lat.name_to_idx[tname]]
                if kub is not None and kub.max_pods is not None:
                    cap = cap.copy()
                    cap[_PODS_AXIS] = kub.clamp_pods(cap[_PODS_AXIS])
                return cap

            def fits(tname: str) -> bool:
                return bool(np.all(node_capacity(tname) <= remaining + 1e-6))

            candidates = node.feasible_types or [node.instance_type]
            fitting = [t for t in candidates if fits(t)]
            if not fitting:
                dropped.append(node)
                continue
            # restrict the claim's launch flexibility to limit-fitting types
            node.feasible_types = fitting
            if node.instance_type not in fitting:
                node.instance_type = fitting[0]  # cheapest-first order
                node.price_per_hour = self._offering_price(node)
            usage[node.node_pool] = current + node_capacity(node.instance_type)
            out.append(node)
        return out, dropped

    def _make_claim(self, node: PlannedNode) -> NodeClaim:
        """NodePlan bin → NodeClaim launch contract. The claim carries the
        bin's full feasible offering sets so the launch path has CreateFleet
        flexibility without a re-solve."""
        pool = self.node_pools[node.node_pool]
        name = f"{node.node_pool}-{next(self._claim_ids):05d}"
        reqs: List[Requirement] = list(pool.requirements)
        if node.feasible_types:
            reqs.append(Requirement(wk.LABEL_INSTANCE_TYPE, Operator.IN,
                                    tuple(node.feasible_types)))
        else:
            reqs.append(Requirement(wk.LABEL_INSTANCE_TYPE, Operator.IN,
                                    (node.instance_type,)))
        reqs.append(Requirement(wk.LABEL_ZONE, Operator.IN,
                                tuple(node.feasible_zones or [node.zone])))
        reqs.append(Requirement(wk.LABEL_CAPACITY_TYPE, Operator.IN,
                                tuple(node.feasible_capacity_types or [node.capacity_type])))
        requests: Dict[str, float] = {}
        total = np.zeros((R,), np.float32)
        for p in node.pods:
            pod = self.cluster.pods.get(p)
            if pod is not None:
                total += resources_to_vec(pod.requests, implicit_pod=True)
        from ..apis.resources import vec_to_resources
        requests = vec_to_resources(total)
        labels = {**pool.labels, **node.extra_labels}
        # a value-free template requirement on a custom key (Exists, or In
        # over several values) means the node must still CARRY the label
        # even when no workload named one — generate/pick it
        # (scheduling.md:554 "Karpenter will generate a random label")
        from ..solver.problem import _is_custom_key
        for r in pool.requirements:
            if not _is_custom_key(r.key) or r.key in labels:
                continue
            if r.operator == Operator.EXISTS:
                labels[r.key] = f"kpat-{name}"
            elif r.operator == Operator.IN and r.values:
                labels[r.key] = sorted(r.values)[0]
        # the node's OS label comes from the pool's resolved OS (the AMI
        # family's, pool_os — the same resolution build_problem pins the
        # pool's constraint to, so label and schedulability always agree)
        from ..apis.objects import pool_os
        labels.setdefault(wk.LABEL_OS, pool_os(pool))
        claim = NodeClaim(
            name=name, node_pool=node.node_pool,
            requirements=reqs, resource_requests=requests,
            labels=labels,
            # template annotations propagate (disruption.md:294 — a
            # do-not-disrupt NodePool shields every node it launches)
            annotations={**pool.annotations,
                         wk.ANNOTATION_NODEPOOL_HASH: nodepool_hash(pool),
                         wk.ANNOTATION_NODEPOOL_HASH_VERSION:
                             NODEPOOL_HASH_VERSION},
            taints=list(pool.taints), node_class_ref=pool.node_class_ref,
            max_pods=(pool.kubelet.max_pods if pool.kubelet is not None
                      else None),
            cluster_dns=(pool.kubelet.cluster_dns if pool.kubelet is not None
                         else None),
            created_at=self.clock.now())
        return claim
