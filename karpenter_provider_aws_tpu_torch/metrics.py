"""Prometheus-style metrics registry.

Mirror of the reference's metric surface (reference website
reference/metrics.md catalog; pkg/providers/instancetype/metrics.go;
batcher metrics): counters, gauges, and histograms with label sets,
rendered in the Prometheus text exposition format. Series names follow the
reference catalog (karpenter_*) so dashboards port over.
"""

from __future__ import annotations

import threading
from bisect import bisect_left
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0,
                   2.5, 5.0, 10.0, 30.0, 60.0)


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames: Sequence[str] = ()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()

    def _key(self, labels: Dict[str, str]) -> Tuple[str, ...]:
        if set(labels) != set(self.labelnames):
            raise ValueError(f"{self.name}: labels {sorted(labels)} != declared {sorted(self.labelnames)}")
        return tuple(str(labels[k]) for k in self.labelnames)


class Counter(_Metric):
    kind = "counter"

    def __init__(self, name, help, labelnames=()):
        super().__init__(name, help, labelnames)
        self._values: Dict[Tuple[str, ...], float] = {}

    def inc(self, amount: float = 1.0, **labels) -> None:
        k = self._key(labels)
        with self._lock:
            self._values[k] = self._values.get(k, 0.0) + amount

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(self._key(labels), 0.0)

    def _render(self) -> List[str]:
        with self._lock:
            return [f"{self.name}{_fmt(self.labelnames, k)} {v}"
                    for k, v in sorted(self._values.items())]


class Gauge(_Metric):
    kind = "gauge"

    def __init__(self, name, help, labelnames=()):
        super().__init__(name, help, labelnames)
        self._values: Dict[Tuple[str, ...], float] = {}

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._values[self._key(labels)] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        k = self._key(labels)
        with self._lock:
            self._values[k] = self._values.get(k, 0.0) + amount

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(self._key(labels), 0.0)

    def clear(self) -> None:
        with self._lock:
            self._values.clear()

    def replace(self, values: Dict[Tuple[str, ...], float]) -> None:
        """Atomically swap the whole series set. For bulk snapshot surfaces
        (the lattice offering gauges) where per-cell set() calls would pay
        label validation ~10k times per refresh."""
        n = len(self.labelnames)
        for k in values:
            if len(k) != n:
                raise ValueError(
                    f"{self.name}: key {k!r} has {len(k)} labels, "
                    f"declared {n}")
        with self._lock:
            self._values = {tuple(map(str, k)): float(v)
                            for k, v in values.items()}

    def _render(self) -> List[str]:
        with self._lock:
            return [f"{self.name}{_fmt(self.labelnames, k)} {v}"
                    for k, v in sorted(self._values.items())]


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name, help, labelnames=(), buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(name, help, labelnames)
        self.buckets = tuple(sorted(buckets))
        self._counts: Dict[Tuple[str, ...], List[int]] = {}
        self._sums: Dict[Tuple[str, ...], float] = {}
        self._totals: Dict[Tuple[str, ...], int] = {}
        # last exemplar per series: (trace_id, observed value). The
        # OpenMetrics bridge between a histogram's aggregate shape and
        # ONE concrete retained trace in the flight recorder
        # (docs/reference/tracing.md) — a dashboard's slow bucket links
        # to `kpctl trace export <trace_id>`.
        self._exemplars: Dict[Tuple[str, ...], Tuple[str, float]] = {}

    def observe(self, value: float, exemplar: Optional[str] = None,
                **labels) -> None:
        k = self._key(labels)
        with self._lock:
            counts = self._counts.setdefault(k, [0] * len(self.buckets))
            # cumulative buckets: every upper bound >= value increments
            for j in range(bisect_left(self.buckets, value), len(self.buckets)):
                counts[j] += 1
            self._sums[k] = self._sums.get(k, 0.0) + value
            self._totals[k] = self._totals.get(k, 0) + 1
            if exemplar is not None:
                self._exemplars[k] = (str(exemplar), float(value))

    def exemplar(self, **labels) -> Optional[Tuple[str, float]]:
        """The series' last (trace_id, value) exemplar, if any."""
        with self._lock:
            return self._exemplars.get(self._key(labels))

    def count(self, **labels) -> int:
        with self._lock:
            return self._totals.get(self._key(labels), 0)

    def sum(self, **labels) -> float:
        with self._lock:
            return self._sums.get(self._key(labels), 0.0)

    def percentile(self, q: float, **labels) -> float:
        """Approximate percentile from bucket counts (upper-bound estimate)."""
        k = self._key(labels)
        with self._lock:
            total = self._totals.get(k, 0)
            counts = self._counts.get(k, [0] * len(self.buckets))
        if total == 0:
            return 0.0
        target = q * total
        for j, b in enumerate(self.buckets):
            if counts[j] >= target:
                return b
        return self.buckets[-1]

    def _render(self) -> List[str]:
        out = []
        with self._lock:
            for k in sorted(self._totals):
                for j, b in enumerate(self.buckets):
                    lbl = _fmt(self.labelnames + ("le",), k + (repr(b),))
                    out.append(f"{self.name}_bucket{lbl} {self._counts[k][j]}")
                lbl = _fmt(self.labelnames + ("le",), k + ("+Inf",))
                out.append(f"{self.name}_bucket{lbl} {self._totals[k]}")
                # exemplar as a COMMENT line: this surface serves the
                # classic text format (text/plain; version=0.0.4), where
                # an OpenMetrics `# {...}` suffix on the sample line
                # would fail the whole scrape — comment lines are
                # ignored by every classic parser, and series without
                # an exemplar render byte-identically to before
                ex = self._exemplars.get(k)
                if ex is not None:
                    out.append(f'# exemplar {self.name}_bucket{lbl} '
                               f'{{trace_id="{ex[0]}"}} {ex[1]}')
                out.append(f"{self.name}_sum{_fmt(self.labelnames, k)} {self._sums[k]}")
                out.append(f"{self.name}_count{_fmt(self.labelnames, k)} {self._totals[k]}")
        return out


def _fmt(names: Sequence[str], values: Sequence[str]) -> str:
    if not names:
        return ""
    inner = ",".join(f'{n}="{v}"' for n, v in zip(names, values))
    return "{" + inner + "}"


class Registry:
    def __init__(self):
        self._metrics: Dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def counter(self, name: str, help: str = "", labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_make(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "", labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_make(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "", labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = Histogram(name, help, labelnames, buckets)
                self._metrics[name] = m
            elif not isinstance(m, Histogram):
                raise ValueError(f"{name} already registered as {m.kind}")
            return m

    def _get_or_make(self, cls, name, help, labelnames):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help, labelnames)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise ValueError(f"{name} already registered as {m.kind}")
            return m

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def render(self) -> str:
        """Prometheus text exposition format."""
        lines: List[str] = []
        with self._lock:
            metrics = sorted(self._metrics.values(), key=lambda m: m.name)
        for m in metrics:
            lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            lines.extend(m._render())
        return "\n".join(lines) + "\n"


# The well-known series (reference website reference/metrics.md) — created
# on a registry by wire_core_metrics so every deployment exposes the same
# names the reference's dashboards scrape.
def wire_core_metrics(reg: Registry) -> Dict[str, _Metric]:
    return {
        "cloudprovider_duration": reg.histogram(
            "karpenter_cloudprovider_duration_seconds",
            "Duration of cloud provider method calls.", ("controller", "method")),
        "cloudprovider_errors": reg.counter(
            "karpenter_cloudprovider_errors_total",
            "Total number of errors returned from CloudProvider calls.",
            ("controller", "method", "error")),
        "scheduling_duration": reg.histogram(
            "karpenter_provisioner_scheduling_duration_seconds",
            "Duration of one scheduling pass (Solve).", ()),
        "scheduling_simulation_duration": reg.histogram(
            "karpenter_provisioner_scheduling_simulation_duration_seconds",
            "Device solve time inside a scheduling pass.", ()),
        "batch_size": reg.histogram(
            "karpenter_provisioner_batch_size",
            "Pending pods per scheduling batch.", (),
            buckets=(1, 5, 10, 50, 100, 500, 1000, 5000, 10000, 50000)),
        "pods_scheduled": reg.counter(
            "karpenter_pods_scheduled_total",
            "Pods placed by the provisioner (scheduling decisions: "
            "direct binds count on success; nominations to pending "
            "claims count at decision time).", ()),
        "pods_unschedulable": reg.gauge(
            "karpenter_pods_unschedulable",
            "Pods the last scheduling pass could not place.", ()),
        # every pod in exactly one phase (state/cluster.py
        # pod_phase_counts): bound | pending | nominated | deleting —
        # refreshed by the state sync pump and after every provisioning
        # pass, so the /metrics view of pod state matches /debug/statusz
        # the decision-explainability surface (solver/explain.py,
        # docs/reference/explain.md): WHY pods are pending, as bounded
        # taxonomy codes (solver/taxonomy.py), and how many offerings
        # each constraint stage eliminated per pass
        "pods_unschedulable_reasons": reg.counter(
            "karpenter_pods_unschedulable_reasons_total",
            "Unschedulable pod observations per scheduling pass, by "
            "structured reason code (unknown-resource | no-offering | "
            "ice-hold | zone-anti-affinity | no-fit | no-existing-fit | "
            "no-new-node-shape | single-bin-full | affinity-presence | "
            "pool-limits | solve-error | uncoded).", ("code",)),
        "explain_eliminations": reg.counter(
            "karpenter_explain_offering_eliminations_total",
            "Offerings removed from signature groups' candidate sets by "
            "each constraint-elimination stage, summed per pass (stage: "
            "resource-fit | requirements | pools | ice | narrowing).",
            ("stage",)),
        "pods_state": reg.gauge(
            "karpenter_pods_state",
            "Pods tracked by cluster state, by phase (bound | pending | "
            "nominated | deleting).", ("phase",)),
        # info-style gauge (value always 1; the payload is the labels) —
        # the standard *_build_info pattern dashboards join on
        "build_info": reg.gauge(
            "karpenter_build_info",
            "Build/runtime info (constant 1; labels carry the payload).",
            ("version", "jax_version", "backend")),
        # rolling SLO burn against the paper's bars
        # (introspect/slo.py): >1.0 means the window is violating
        # the 200 ms p50 latency / 2% FFD-referee cost budget
        "slo_latency_burn": reg.gauge(
            "karpenter_slo_latency_budget_burn",
            "Rolling-window p50 end-to-end provision latency over the "
            "200 ms budget (burn > 1.0 = out of SLO).", ()),
        "slo_cost_burn": reg.gauge(
            "karpenter_slo_cost_budget_burn",
            "Rolling-window solve cost regression vs the FFD referee "
            "over the 2% budget (burn > 1.0 = out of SLO).", ()),
        # the solver degradation ladder (docs/concepts/degradation.md):
        # device solve → wave-split → host FFD. Operators alarm on the
        # degraded counter; the wave histogram shows how often the group
        # axis overflows; the retry counter separates transient device
        # weather from real fallbacks.
        "solver_degraded": reg.counter(
            "karpenter_solver_degraded_total",
            "Scheduling passes that left the primary device-solve path, "
            "by degradation rung (path: wave-split | host-ffd | none) and "
            "reason (g-overflow | b-exhausted | device-error | "
            "internal-error | solve-error | sidecar-hung | "
            "sidecar-unreachable | pool-exhausted).", ("path", "reason")),
        "solver_device_retries": reg.counter(
            "karpenter_solver_device_retries_total",
            "Transient device-solve failures retried before any fallback "
            "engaged.", ()),
        # the steady-state incremental path (solver/incremental.py +
        # Solver.solve_delta): passes whose problem was patched from the
        # previous build and solved against device-resident input state
        # instead of a from-scratch rebuild + full upload
        "solver_delta_solves": reg.counter(
            "karpenter_solver_delta_solves_total",
            "Provisioning passes carried by the steady-state delta-solve "
            "path (incremental problem build + device-resident input "
            "delta).", ()),
        "solver_dirty_groups": reg.histogram(
            "karpenter_solver_dirty_group_count",
            "Signature groups whose membership changed per delta solve "
            "(the re-tensorized share of the problem).", (),
            buckets=(0, 1, 2, 4, 8, 16, 32, 64)),
        # host↔device link accounting (docs/reference/microloop.md): a
        # LEG is a transfer whose size scales with the problem or plan
        # (fused input uploads, dirty-block scatters, result fetches);
        # O(1) control syncs — the microloop's changed-plan fingerprint
        # — are excluded, because they cannot regress to full
        # re-staging. A steady-state microloop pass pays ≤2 legs (one
        # dirty upload, one CONDITIONAL plan fetch); a pass that
        # silently regresses to full re-staging shows up here without
        # waiting for a bench.
        "solver_link_legs": reg.counter(
            "karpenter_solver_link_legs_total",
            "Host-device link transfers on the solve path (direction: "
            "upload | fetch). Steady-state microloop passes are bounded "
            "at one dirty upload plus one conditional plan fetch.",
            ("direction",)),
        "solver_link_bytes": reg.counter(
            "karpenter_solver_link_bytes_total",
            "Bytes that crossed the host-device link on the solve path "
            "(direction: upload | fetch).", ("direction",)),
        # the mesh production path (parallel/mesh.py + docs/reference/
        # sharding.md): device count of the solver's mesh and the last
        # sharded solve's per-shard load balance. devices == 1 means the
        # single-device passthrough; imbalance is max/mean per-shard pod
        # load (1.0 = perfectly balanced; the round-robin whole-group
        # assignment and shard-0 pinning of need-groups show up here).
        "solver_mesh_devices": reg.gauge(
            "karpenter_solver_mesh_devices",
            "Devices in the solver's production mesh (1 = single-device "
            "path; >1 = the pod-axis sharded solve carries every pass).",
            ()),
        "solver_shard_imbalance": reg.gauge(
            "karpenter_solver_shard_imbalance_ratio",
            "Max/mean per-shard pod load of the last sharded solve's "
            "group split (1.0 = balanced; 0 until a sharded solve runs).",
            ()),
        # the solver failover pool (parallel/pool.py SolverPool;
        # docs/reference/solver-pool.md): endpoint count/health, the
        # cumulative failed-attempt counter, local final-rung solves,
        # and one breaker-state series per endpoint address. All zero /
        # absent without --solver-address.
        "solver_pool_endpoints": reg.gauge(
            "karpenter_solver_pool_endpoints",
            "Solver sidecar endpoints configured in the failover pool "
            "(0 = in-process solver, no pool).", ()),
        "solver_pool_healthy": reg.gauge(
            "karpenter_solver_pool_healthy_endpoints",
            "Pool endpoints whose circuit breaker is closed (routable "
            "for solves).", ()),
        "solver_pool_failovers": reg.gauge(
            "karpenter_solver_pool_failovers",
            "Cumulative failed endpoint attempts that fell through to "
            "another endpoint or the local rung (monotonic; mirrored "
            "from pool stats each gauge pass).", ()),
        "solver_pool_local_solves": reg.gauge(
            "karpenter_solver_pool_local_solves",
            "Cumulative passes the LOCAL solver carried because every "
            "pool endpoint was dark (degraded_reason=pool-exhausted).",
            ()),
        "solver_pool_breaker_state": reg.gauge(
            "karpenter_solver_pool_breaker_state",
            "Per-endpoint circuit breaker state (0 = closed, 1 = "
            "half-open probation, 2 = open).", ("endpoint",)),
        "solver_waves": reg.histogram(
            "karpenter_solver_wave_count",
            "Waves per scheduling solve (1 = one device pass; >1 = the "
            "group axis wave-split).", (),
            buckets=(1, 2, 4, 8, 16, 32, 64)),
        # per-stage share of the device solve (solver/pipeline.py STAGES)
        # — the observable proof that the pipelined path overlaps host
        # work with the in-flight device call: under overlap, "download"
        # (the residual blocking wait) shrinks while "build"/"upload"
        # stay constant (docs/concepts/performance.md "Pipelining & the
        # tunnel link")
        "solver_stage_duration": reg.histogram(
            "karpenter_solver_stage_duration_seconds",
            "Wall-clock share of one scheduling solve per pipeline stage "
            "(stage: build | upload | compute | download | decode).",
            ("stage",)),
        # the API stratum's write/fan-out surface (kube/apiserver.py;
        # docs/reference/watch.md) — set from FakeAPIServer.stats() each
        # gauge pass in API mode. Cumulative values are exposed as
        # gauges because they mirror a snapshot counter, like the other
        # stats()-backed series.
        "api_watchers": reg.gauge(
            "karpenter_api_watchers",
            "Active watch subscriptions on the apiserver's watch hub.", ()),
        "api_watch_queue_depth": reg.gauge(
            "karpenter_api_watch_queue_depth",
            "Queued (undelivered) watch events across all subscribers.", ()),
        "api_watch_max_depth": reg.gauge(
            "karpenter_api_watch_max_queue_depth",
            "Deepest single watcher queue at the last snapshot (the "
            "slow-consumer early-warning before the bound drops it).", ()),
        "api_watch_delivered": reg.gauge(
            "karpenter_api_watch_events_delivered",
            "Watch events delivered to subscriber queues (cumulative; "
            "shared-envelope delivery — no per-watcher copies).", ()),
        "api_watch_bookmarks": reg.gauge(
            "karpenter_api_watch_bookmarks",
            "BOOKMARK events sent to keep idle watchers' resume RVs "
            "fresh (cumulative).", ()),
        "api_watch_drops": reg.gauge(
            "karpenter_api_watch_drops",
            "Watch events discarded because a subscriber overran its "
            "bounded queue and was dropped to 410/relist (cumulative).",
            ()),
        "api_bulk_ops": reg.gauge(
            "karpenter_api_bulk_ops",
            "Write operations applied through the coalescing bulk verb "
            "(cumulative; one lock acquisition per kind per batch).", ()),
        "api_fanout_copies": reg.gauge(
            "karpenter_api_fanout_envelope_copies",
            "Per-watcher envelope copies made on the watch fan-out path "
            "(pinned 0: delivery shares one frozen envelope per RV).", ()),
        # the saturation observatory (introspect/headroom.py;
        # docs/reference/headroom.md): one row per registered bounded
        # resource, emitted via Gauge.replace each gauge pass so a
        # resource that unregisters disappears instead of flatlining
        "headroom_depth": reg.gauge(
            "karpenter_headroom_depth",
            "Current occupancy of a registered bounded resource, by "
            "resource.", ("resource",)),
        "headroom_capacity": reg.gauge(
            "karpenter_headroom_capacity",
            "Configured capacity of a registered bounded resource (0 = "
            "unbounded, forecast-only), by resource.", ("resource",)),
        "headroom_highwater": reg.gauge(
            "karpenter_headroom_highwater",
            "Process-monotonic high-water occupancy of a registered "
            "bounded resource (never resets on read or on structure "
            "churn), by resource.", ("resource",)),
        "headroom_drops": reg.gauge(
            "karpenter_headroom_drops",
            "Cumulative overflow/drop count of a registered bounded "
            "resource (mirrors the structure's own drop counter), by "
            "resource.", ("resource",)),
        "headroom_fill_rate": reg.gauge(
            "karpenter_headroom_fill_rate",
            "EWMA inflow pressure of a registered bounded resource in "
            "items/second (drops count as inflow), by resource.",
            ("resource",)),
        "headroom_tte": reg.gauge(
            "karpenter_headroom_seconds_to_exhaustion",
            "Forecast seconds until a queue-kind resource exhausts its "
            "capacity at the current EWMA net fill (-1 = no exhaustion "
            "in sight), by resource.", ("resource",)),
        # lock contention accounting (introspect/contention.py): wait to
        # acquire a hot control-plane lock, observed ONLY on contention
        # (the uncontended path records nothing). Labeled by lock name —
        # cluster_state, solver_solve, api_server, batcher_bucket,
        # solve_window, writer, flight_recorder, watch_event.
        "lock_wait": reg.histogram(
            "karpenter_lock_wait_seconds",
            "Time a thread blocked acquiring a contended control-plane "
            "lock, by lock.", ("lock",),
            buckets=(0.00005, 0.0002, 0.001, 0.005, 0.02, 0.05, 0.1, 0.5,
                     2.0)),
        # reference metrics.md:62,16,19
        "pods_startup_time": reg.histogram(
            "karpenter_pods_startup_time_seconds",
            "Seconds from pod arrival to its first bind.", (),
            # startup includes node launch + registration: minutes, not
            # the sub-minute default buckets
            buckets=(1.0, 5.0, 15.0, 30.0, 60.0, 120.0, 300.0,
                     600.0, 1800.0)),
        "nodepool_usage": reg.gauge(
            "karpenter_nodepool_usage",
            "Capacity committed per NodePool.",
            ("nodepool", "resource_type")),
        "nodepool_limit": reg.gauge(
            "karpenter_nodepool_limit",
            "The NodePool's spec.limits ceiling.",
            ("nodepool", "resource_type")),
        "nodeclaims_created": reg.counter(
            "karpenter_nodeclaims_created_total", "NodeClaims created.", ("nodepool",)),
        "nodeclaims_launched": reg.counter(
            "karpenter_nodeclaims_launched_total", "NodeClaims launched.", ("nodepool",)),
        "nodeclaims_registered": reg.counter(
            "karpenter_nodeclaims_registered_total", "NodeClaims registered.", ("nodepool",)),
        "nodeclaims_initialized": reg.counter(
            "karpenter_nodeclaims_initialized_total", "NodeClaims initialized.", ("nodepool",)),
        "nodeclaims_terminated": reg.counter(
            "karpenter_nodeclaims_terminated_total", "NodeClaims terminated.", ("nodepool",)),
        "nodeclaims_disrupted": reg.counter(
            "karpenter_nodeclaims_disrupted_total", "NodeClaims voluntarily disrupted.",
            ("nodepool", "reason")),
        # the vmapped consolidation engine (solver/consolidate.py;
        # docs/reference/consolidation.md): batched what-if dispatch,
        # zero-leg cache hits, host-ladder fallbacks, the FFD savings
        # referee, and the coded not-consolidated skip reasons
        "disruption_vmapped_whatifs": reg.counter(
            "karpenter_disruption_vmapped_whatifs_total",
            "Batched consolidation what-if dispatches (one vmapped probe "
            "kernel launch covering a whole candidate batch).", ()),
        "disruption_whatif_candidates": reg.counter(
            "karpenter_disruption_whatif_candidates_total",
            "Candidate removal sets evaluated by batched consolidation "
            "what-if dispatches.", ()),
        "disruption_whatif_cached": reg.counter(
            "karpenter_disruption_whatif_cached_total",
            "Candidate removal sets served from the fingerprint-unchanged "
            "delta cache at zero device sync legs.", ()),
        "disruption_whatif_host_fallbacks": reg.counter(
            "karpenter_disruption_whatif_host_fallbacks_total",
            "Candidate removal sets outside the vmapped envelope "
            "(wave-scale G, pinned groups on a mesh) evaluated on the "
            "host what-if ladder instead.", ()),
        "disruption_consolidation_skips": reg.counter(
            "karpenter_disruption_consolidation_skips_total",
            "Nodes skipped by the consolidation engine, by coded reason "
            "(solver/taxonomy.py: not-consolidatable-pdb | "
            "not-consolidatable-budget | consolidation-no-savings | "
            "consolidation-weather-hold | consolidation-spot-guard).",
            ("code",)),
        "disruption_consolidation_savings": reg.gauge(
            "karpenter_disruption_consolidation_savings_per_hour",
            "Cumulative accepted consolidation savings in $/hr (removed "
            "capacity price minus replacement price, summed over accepted "
            "removals).", ()),
        "interruption_received": reg.counter(
            "karpenter_interruption_received_messages_total",
            "Interruption queue messages received.", ("message_type",)),
        "interruption_deleted": reg.counter(
            "karpenter_interruption_deleted_messages_total",
            "Interruption queue messages deleted.", ()),
        "interruption_actions": reg.counter(
            "karpenter_interruption_actions_performed_total",
            "Node drain actions taken for interruption messages.", ("action",)),
        # robustness surface (interruption/controller.py): every body the
        # controller pulled, by parsed kind — malformed/unknown bodies are
        # counted and dropped, never crash the controller loop (kind:
        # spot-interruption | rebalance-recommendation | scheduled-change |
        # state-change | noop | malformed)
        "interruption_messages": reg.counter(
            "karpenter_interruption_messages_total",
            "Interruption queue messages processed, by parsed kind "
            "(malformed bodies count under kind=\"malformed\" and are "
            "dropped without crashing the controller).", ("kind",)),
        "interruption_queue_depth": reg.gauge(
            "karpenter_interruption_queue_depth",
            "Messages currently in the interruption queue (sent, not yet "
            "deleted) at the last reconcile.", ()),
        # the adversarial weather simulator (weather/; docs/reference/
        # weather.md): live scenario state while a --weather soak or the
        # CI squall smoke drives the control plane
        "weather_storm_active": reg.gauge(
            "karpenter_weather_storm_active",
            "Interruption storms currently active in the weather "
            "scenario (0 = fair weather).", ()),
        "weather_ice_pools": reg.gauge(
            "karpenter_weather_ice_pools",
            "Offerings currently held out of capacity by the weather "
            "simulator's ICE field.", ()),
        "weather_spot_mult_mean": reg.gauge(
            "karpenter_weather_spot_price_multiplier_mean",
            "Mean spot-price multiplier over the base market across all "
            "(family, zone) walks.", ()),
        "weather_spot_mult_max": reg.gauge(
            "karpenter_weather_spot_price_multiplier_max",
            "Worst-case spot-price multiplier over the base market "
            "across all (family, zone) walks.", ()),
        "weather_ticks": reg.gauge(
            "karpenter_weather_ticks",
            "Weather ticks simulated so far (the deterministic timeline "
            "index).", ()),
        "weather_events": reg.counter(
            "karpenter_weather_events_total",
            "Weather timeline events applied, by kind (reprice | regime | "
            "storm-begin | storm-burst | storm-end | ice | ice-thaw | "
            "device).", ("kind",)),
        "cluster_state_synced": reg.gauge(
            "karpenter_cluster_state_synced",
            "1 when cluster state has synced with the cloud (reference "
            "metrics.md:152: readiness of the state mirror).", ()),
        "cluster_state_node_count": reg.gauge(
            "karpenter_cluster_state_node_count", "Nodes tracked by cluster state.", ()),
        "cluster_state_pod_count": reg.gauge(
            "karpenter_cluster_state_pod_count", "Pods tracked by cluster state.", ()),
        "ice_cache_size": reg.gauge(
            "karpenter_ice_cache_size", "Offerings currently marked unavailable.", ()),
        # zero-downtime operator handoff (state/replication.py +
        # operator/leaderelection.py; docs/reference/handoff.md): leader/
        # standby role, the monotonic fencing token, and the replication
        # stream's progress — only exported once wire_handoff() ran
        "operator_leader_state": reg.gauge(
            "karpenter_operator_leader_state",
            "1 while this replica holds the leader lease, 0 on a standby "
            "(mirrors the elector's view; flips on promotion/demotion).", ()),
        "handoff_fence_token": reg.gauge(
            "karpenter_operator_handoff_fence_token",
            "Fencing token under which this replica last held the lease "
            "(monotonic across takeovers; a zombie leader's writes carry "
            "a stale token and are rejected).", ()),
        "handoff_fenced_writes": reg.gauge(
            "karpenter_operator_handoff_fenced_writes",
            "Side-effectful writes rejected by the fence guard because "
            "the lease was lost or the token rotated (each one is a "
            "zombie-leader action that did NOT race the new leader).", ()),
        "handoff_snapshots": reg.gauge(
            "karpenter_operator_handoff_snapshots",
            "Full state snapshots taken over the replication stream "
            "(leader: served; standby: applied).", ()),
        "handoff_deltas": reg.gauge(
            "karpenter_operator_handoff_deltas",
            "Incremental journal deltas streamed over the replication "
            "transport (leader: served; standby: applied).", ()),
        "handoff_rebuilds": reg.gauge(
            "karpenter_operator_handoff_rebuilds",
            "Standby full rebuilds forced by the cutover ladder, by "
            "reason (stale-anchor | snapshot-version-mismatch).",
            ("reason",)),
        "handoff_lease_transitions": reg.gauge(
            "karpenter_operator_handoff_lease_transitions",
            "Leadership transitions this elector observed on itself "
            "(promotions + demotions).", ()),
    }


# The per-instance-type / per-offering gauge surface (reference
# pkg/providers/instancetype/metrics.go:32-79): hardware shape per type,
# availability + price estimate per type×capacity-type×zone offering.
def wire_lattice_metrics(reg: Registry) -> Dict[str, Gauge]:
    return {
        "instance_type_cpu": reg.gauge(
            "karpenter_cloudprovider_instance_type_cpu_cores",
            "VCPUs cores for a given instance type.", ("instance_type",)),
        "instance_type_memory": reg.gauge(
            "karpenter_cloudprovider_instance_type_memory_bytes",
            "Memory, in bytes, for a given instance type.", ("instance_type",)),
        "offering_available": reg.gauge(
            "karpenter_cloudprovider_instance_type_offering_available",
            "Instance type offering availability, based on instance type, "
            "capacity type, and zone.",
            ("instance_type", "capacity_type", "zone")),
        "offering_price": reg.gauge(
            "karpenter_cloudprovider_instance_type_offering_price_estimate",
            "Instance type offering estimated hourly price, based on "
            "instance type, capacity type, and zone.",
            ("instance_type", "capacity_type", "zone")),
    }


# ---- wire-format lint (promtool-style) ------------------------------------

_METRIC_NAME_RE = None   # compiled lazily in lint_exposition
_SAMPLE_RE = None
_LABEL_RE = None


def lint_exposition(text: str) -> List[str]:
    """Promtool-style lint of a classic text-format exposition.

    Returns a list of problem strings (empty = clean). Enforced, in the
    spirit of `promtool check metrics` plus the scrape-safety rules this
    repo's exemplar-comment rendering depends on:

    - every sample's family declares ``# HELP`` then ``# TYPE`` (in that
      order, once each) BEFORE its first sample; TYPE is a known kind
    - family sample blocks are contiguous (no interleaving) — the
      ordering real scrapers rely on for streaming parses
    - sample lines parse: valid metric/label names, correctly escaped
      label values, a float-parseable value; no duplicate series
    - histogram families: ``le`` upper bounds strictly increase, bucket
      counts are monotonically non-decreasing, the ``+Inf`` bucket exists
      and AGREES with ``_count``, and ``_sum``/``_count`` are present
    - comment lines other than HELP/TYPE (e.g. the ``# exemplar`` lines
      tracing attaches after ``+Inf``) must stay scrape-safe: they start
      with ``# `` and never shadow a HELP/TYPE declaration
    """
    import re
    global _METRIC_NAME_RE, _SAMPLE_RE, _LABEL_RE
    if _METRIC_NAME_RE is None:
        _METRIC_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
        _SAMPLE_RE = re.compile(
            r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?\s+(\S+)(?:\s+(-?\d+))?$")
        _LABEL_RE = re.compile(
            r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\\n]|\\["\\n])*)"')
    problems: List[str] = []
    helps: Dict[str, str] = {}
    types: Dict[str, str] = {}
    seen_series: set = set()
    block_order: List[str] = []   # family per contiguous sample block
    # family -> {series key -> (labels, value)} for histogram agreement
    hist_samples: Dict[str, List[Tuple[str, Dict[str, str], float]]] = {}

    def family_of(name: str) -> str:
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) and name[: -len(suffix)] in types:
                return name[: -len(suffix)]
        return name

    for ln, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 3 and parts[1] in ("HELP", "TYPE"):
                name = parts[2]
                if not _METRIC_NAME_RE.match(name):
                    problems.append(f"line {ln}: bad metric name {name!r}")
                    continue
                if parts[1] == "HELP":
                    if name in helps:
                        problems.append(f"line {ln}: duplicate HELP {name}")
                    if name in types:
                        problems.append(
                            f"line {ln}: HELP {name} after its TYPE")
                    helps[name] = parts[3] if len(parts) > 3 else ""
                else:
                    kind = parts[3].strip() if len(parts) > 3 else ""
                    if kind not in ("counter", "gauge", "histogram",
                                    "summary", "untyped"):
                        problems.append(
                            f"line {ln}: TYPE {name} unknown kind {kind!r}")
                    if name in types:
                        problems.append(f"line {ln}: duplicate TYPE {name}")
                    if name not in helps:
                        problems.append(f"line {ln}: TYPE {name} has no "
                                        "preceding HELP")
                    types[name] = kind
            elif not line.startswith("# "):
                problems.append(f"line {ln}: comment without '# ' prefix "
                                "is not scrape-safe")
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            problems.append(f"line {ln}: unparseable sample {line!r}")
            continue
        name, labelstr, value = m.group(1), m.group(2), m.group(3)
        labels: Dict[str, str] = {}
        if labelstr:
            matched = _LABEL_RE.findall(labelstr)
            # reconstruction check: every byte of the label block must be
            # consumed by well-formed pairs (catches unescaped quotes /
            # backslashes that a lenient findall would silently skip)
            rebuilt = ",".join(f'{k}="{v}"' for k, v in matched)
            if rebuilt != labelstr.rstrip(","):
                problems.append(
                    f"line {ln}: malformed/unescaped labels {labelstr!r}")
                continue
            labels = dict(matched)
        try:
            val = float(value)
        except ValueError:
            problems.append(f"line {ln}: unparseable value {value!r}")
            continue
        fam = family_of(name)
        if fam not in types:
            problems.append(f"line {ln}: sample {name} has no TYPE")
        elif types[fam] == "histogram":
            if name == fam:
                problems.append(f"line {ln}: histogram {fam} exposes a "
                                "bare sample (want _bucket/_sum/_count)")
            hist_samples.setdefault(fam, []).append((name, labels, val))
        series = (name, tuple(sorted(labels.items())))
        if series in seen_series:
            problems.append(f"line {ln}: duplicate series {name}"
                            f"{dict(labels)}")
        seen_series.add(series)
        if not block_order or block_order[-1] != fam:
            block_order.append(fam)
    for i, fam in enumerate(block_order):
        if fam in block_order[:i]:
            problems.append(f"family {fam}: sample block is not contiguous")
            break
    # histogram agreement per series (labels minus le)
    for fam, samples in hist_samples.items():
        groups: Dict[Tuple, Dict[str, object]] = {}
        for name, labels, val in samples:
            key = tuple(sorted((k, v) for k, v in labels.items()
                               if k != "le"))
            g = groups.setdefault(key, {"buckets": [], "sum": None,
                                        "count": None})
            if name.endswith("_bucket"):
                le = labels.get("le")
                if le is None:
                    problems.append(f"{fam}: bucket without le {labels}")
                    continue
                g["buckets"].append((float(le), val))
            elif name.endswith("_sum"):
                g["sum"] = val
            elif name.endswith("_count"):
                g["count"] = val
        for key, g in groups.items():
            buckets = g["buckets"]
            lbl = dict(key)
            if not buckets:
                continue
            les = [le for le, _ in buckets]
            if les != sorted(les):
                problems.append(f"{fam}{lbl}: le bounds out of order")
            if len(set(les)) != len(les):
                problems.append(f"{fam}{lbl}: duplicate le bounds")
            counts = [c for _, c in sorted(buckets)]
            if any(b > a for a, b in zip(counts[1:], counts)):
                problems.append(f"{fam}{lbl}: bucket counts decrease")
            if not any(le == float("inf") for le in les):
                problems.append(f"{fam}{lbl}: missing +Inf bucket")
            else:
                inf_count = dict(buckets)[float("inf")]
                if g["count"] is not None and inf_count != g["count"]:
                    problems.append(
                        f"{fam}{lbl}: +Inf bucket {inf_count} != _count "
                        f"{g['count']}")
            if g["sum"] is None:
                problems.append(f"{fam}{lbl}: missing _sum")
            if g["count"] is None:
                problems.append(f"{fam}{lbl}: missing _count")
    return problems


def emit_lattice_gauges(gauges: Dict[str, Gauge], lattice,
                        ice_mask=None) -> None:
    """Bulk-refresh the offering gauge surface straight from the lattice
    tensors (price/available are already [T,Z,C] arrays — the whole surface
    is four dict builds, no per-offering provider calls). ``ice_mask`` is
    the UnavailableOfferings mask; ICE'd offerings report available=0 the
    same way the reference folds its unavailableOfferings cache into
    createOfferings (instancetype.go:175-201)."""
    import numpy as np

    gauges["instance_type_cpu"].replace(
        {(s.name,): s.vcpus for s in lattice.specs})
    gauges["instance_type_memory"].replace(
        {(s.name,): s.memory_mib * 1024 * 1024 for s in lattice.specs})
    avail = lattice.available
    if ice_mask is not None:
        avail = avail & ice_mask
    offered = np.argwhere(np.isfinite(lattice.price))
    av: Dict[Tuple[str, ...], float] = {}
    pr: Dict[Tuple[str, ...], float] = {}
    names, zones, caps = lattice.names, lattice.zones, lattice.capacity_types
    for ti, zi, ci in offered:
        key = (names[ti], caps[ci], zones[zi])
        av[key] = 1.0 if avail[ti, zi, ci] else 0.0
        pr[key] = float(lattice.price[ti, zi, ci])
    gauges["offering_available"].replace(av)
    gauges["offering_price"].replace(pr)
