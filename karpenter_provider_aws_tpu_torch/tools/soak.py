"""soak — wall-clock chaos soak of the threaded control plane, for this
package.

The counterpart of the repository's ``tools/soak.py``, with the same
flags, gates, output and exit codes, run as

    python -m karpenter_provider_aws_tpu_torch.tools.soak [--device cuda] ...

It differs where the port does: ``--device`` (default ``cuda``, raising
without a card) places every Solver of the run (the Operator's, the
standby's, the pool's sidecars'); ``--compile-cache-dir`` is where the
kernel libraries and the native referee are built and loaded, as in the
port's CLI (``--warm-start`` with it builds them first and records each
shape's analysis); and the artifacts default to names of their own (``SOAK_gpu_timeseries.json.gz``,
``WEATHER_gpu_<scenario>.json.gz``), so a run never writes over the JAX
rounds' files. Each gate that fails is also recorded: the run's last
lines but one print ``soak: failed gates <JSON list>``, and the weather
artifact carries the list (``failed_gates``) beside the convergence
counts of its ``soak`` record (``pending``, ``leaked``,
``orphan_leases``), the Solver's device and the process's kernel
launches.

The committed analog of the reference's long-running e2e chaos suite
(test/suites/chaos + the scale deprovisioning matrix run against a real
cluster for hours): every controller on its own thread
(operator/runtime.ControllerRuntime), real time, and a churn driver that
injects the full fault surface — pod waves, heavy deletion (consolidation
pressure), spot interruption messages, transient API errors, and ICE'd
capacity pools.

Exit criteria (after churn stops, the control plane must converge):
- zero pending pods,
- zero leaked instances (checked AFTER the GC grace window — an instance
  the GC hasn't been entitled to reap yet is not a leak),
- zero orphaned node leases.

Usage: python -m karpenter_provider_aws_tpu_torch.tools.soak [--minutes 5] [--seed 0]
       [--out SOAK_gpu_timeseries.json.gz]
Exits non-zero if any invariant fails (and prints a full control-plane
dump). A 6-minute run churns ~20k pods. The run records a time-series
artifact (pending/nodes/claims/cost per second — the reference's
monitor.go + Timestream metrics-pipeline analog, debug.Monitor).

``--fault-schedule`` drives the SOLVER degradation ladder
(docs/concepts/degradation.md) mid-soak, on top of the cloud chaos:
a comma-separated list of ``SECONDS:ACTION`` entries applied once the
run clock passes each mark. Actions: ``device-error[=N]`` (inject N
device failures, default 3), ``g-limit=N`` (fake group-bucket ceiling
→ wave-split), ``b-limit=N`` (fake bin-table ceiling → host-FFD
fallback), ``clear`` (drop all injected ceilings). Example:
``--fault-schedule 30:device-error,60:g-limit=64,120:clear``. Faults
are always cleared before convergence, and the run prints the
solver's degraded counters so a soak can assert the ladder actually
fired.

``--pipeline`` exercises the overlapped solve path
(docs/concepts/performance.md "Pipelining & the tunnel link") under the
same sustained churn: the pipelined path is forced on, and the run
FAILS unless it actually engaged — the solver's async-dispatch counter
and the resident-input cache's hit/shipped counters are printed and
asserted non-vacuous, so "pipelined soak passed" can never mean "soak
quietly ran sequential".

``--weather <scenario|file>`` drives the adversarial weather simulator
(weather/; docs/reference/weather.md) over the run: a seed-deterministic
spot-market walk repriced into the lattice every tick, ICE spells
holding offerings out of capacity, correlated interruption storms (all
four EventBridge schemas + junk bodies), and device weather through the
solver's FaultInjector — composable with ``--fault-schedule``. The run
then GATES on the paper's bars holding *while degraded*: sustained
latency burn < 1.0 and cost burn <= 1.0 (i.e. <=2% vs the FFD referee),
the ladder demonstrably engaged, interruptions demonstrably handled,
and the recorded weather timeline byte-identical to a same-seed replay.
The verdict + timeline land in a ``WEATHER_*.json.gz`` artifact
(``--weather-out``).

``--consol-out PATH`` arms the CONSOLIDATION verdict
(docs/reference/consolidation.md): the default pool gets
WhenUnderutilized consolidation (``--consolidate-after``), the deletion
waves carve out underutilized nodes, and the run GATES on the vmapped
engine demonstrably carrying the search — accepted removals with
cumulative savings, batched dispatches (>1 candidate set per device
call), fingerprint-unchanged candidates served from the zero-leg probe
cache, and every accept refereed against the host FFD oracle. The
savings-per-hour trajectory (per-sample ``consolidation`` provider
series) lands in a ``CONSOL_*.json.gz`` artifact. With a weather
scenario attached, consolidation additionally rides the advisory: a
scripted spot-crash regime must record HOLDS during the crash window
(``consolidation-weather-hold`` counted > 0) and savings RESUMING after
it clears — zero activity alone never passes.

``--solver-pool N`` composes CONTROL-PLANE weather with all of the
above: N chaos-capable solver sidecars are spawned in-process on unix
sockets and the operator runs against them as a failover pool
(parallel/pool.py SolverPool). Scenario ``SidecarOutage`` elements (the
``blackout`` scenario) kill/hang/junk the endpoints mid-run; the run
then gates on failovers > 0, zero solve-error passes, the local rung
engaging ONLY under a scripted full blackout, and every breaker closed
again after the outage window (docs/reference/solver-pool.md).

``--standby`` spawns a live WARM STANDBY operator (state/replication.py
+ operator/leaderelection.py; docs/reference/handoff.md): a second
Operator sharing the clock/cloud/lattice/queue, its mirror fed by
snapshot + journal-delta streaming over a unix-socket replication
server, pre-building every delta through IncrementalProblemBuilder,
its controllers leadership-gated behind a fence-carrying FileLeaseStore
lease. Scenario ``OperatorKill`` elements (the ``handoff`` scenario)
crash-stop or hang the ACTIVE operator mid-storm; the run then gates on
the standby promoting within the lease window, carrying its first
provisioning pass promptly, the fence token rotating, no duplicate
provider IDs across the handoff, and the usual weather bars (burn,
replay-identical timeline) holding ACROSS the cutover.

Every soak ends with the SATURATION verdict (introspect/headroom.py;
docs/reference/headroom.md): the final first-to-break table prints,
and any queue-kind resource whose monotonic high water reached its
capacity must be explained by the weather scenario or a deliberately
tightened bound, or the run fails. ``--api-watch-queue-bound N`` arms
the prediction drill on top: one deliberately idle pods watcher is
parked so its queue fills at the churn event rate, and the run GATES
on the forecaster ranking ``api_watch_queues`` first-to-break BEFORE
its first overflow — the observatory must predict the break, not
narrate it. ``--headroom-out`` records the ranked table, the
per-sample saturation trajectory, and the forecast-vs-overflow
timestamps in a ``HEADROOM_*.json.gz`` artifact.
"""

from __future__ import annotations

import argparse
import random
import sys
import time

from ..apis import Pod
from ..controllers.garbagecollection import LEAK_GRACE_SECONDS
from ..errors import NotFoundError
from ..interruption.messages import spot_interruption
from ..interruption.queue import FakeQueue
from ..lattice import build_catalog, build_lattice
from ..operator import Operator, Options
from ..operator.runtime import ControllerRuntime, operator_specs
from ..ops import offering_argmin
from ..solver import FaultInjector

DEFAULT_OUT = "SOAK_gpu_timeseries.json.gz"


def parse_fault_schedule(spec: str):
    """'30:device-error,60:g-limit=64' → sorted [(30.0, 'device-error',
    None), (60.0, 'g-limit', 64)]."""
    out = []
    for entry in filter(None, (e.strip() for e in spec.split(","))):
        at, _, action = entry.partition(":")
        if not _:
            raise SystemExit(f"fault entry {entry!r}: want SECONDS:ACTION")
        name, _, val = action.partition("=")
        name = name.strip()
        if name not in ("device-error", "g-limit", "b-limit", "clear"):
            raise SystemExit(f"unknown fault action {name!r}")
        if name in ("g-limit", "b-limit") and not val:
            raise SystemExit(f"fault action {name} needs =N")
        out.append((float(at), name, int(val) if val else None))
    return sorted(out)


def full_blackout_scripted(scenario, n_endpoints: int) -> bool:
    """True when the scenario's SidecarOutage windows cover EVERY pool
    endpoint at some instant — the only condition under which the local
    solve rung is allowed to engage (degraded_reason=pool-exhausted)."""
    if n_endpoints <= 0 or not scenario.sidecar_outages:
        return False
    edges = sorted({o.at for o in scenario.sidecar_outages}
                   | {o.at + o.duration for o in scenario.sidecar_outages})
    for a, b in zip(edges, edges[1:]):
        mid = (a + b) / 2.0
        out = {o.endpoint for o in scenario.sidecar_outages
               if o.at <= mid < o.at + o.duration}
        if set(range(n_endpoints)) <= out:
            return True
    return False


class OperatorHandle:
    """The weather simulator's operator-chaos seam (weather/simulator.py
    ``operators=``): kill = crash-stop the runtime WITHOUT releasing the
    lease (a crashed process never runs its shutdown path — the standby
    must wait out the lease), hang = freeze every controller thread
    including the election tick (the zombie-leader mode: resume releases
    the queued writes straight into the write fence)."""

    def __init__(self, runtime):
        self.runtime = runtime
        self.killed_at = None

    def kill(self) -> None:
        self.killed_at = time.monotonic()
        self.runtime.crash_stop()

    def restart(self) -> None:
        pass   # a dead leader staying dead is the acceptance shape

    def set_hang(self, hung: bool) -> None:
        if hung:
            self.killed_at = time.monotonic()
            self.runtime.pause()
        else:
            self.runtime.resume()


def apply_fault(solver, name: str, val):
    """Apply one schedule entry to the solver's (possibly new) injector.
    Mutations take the injector's own lock: the operator thread is
    consuming device_errors concurrently via take_device_error."""
    if name == "clear":
        solver.inject_faults(None)
        return
    inj = solver.faults or FaultInjector()
    with inj._lock:
        if name == "device-error":
            inj.device_errors += val if val is not None else 3
        elif name == "g-limit":
            inj.g_limit = val
        elif name == "b-limit":
            inj.b_limit = val
    solver.inject_faults(inj)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--minutes", type=float, default=5.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--families", default="m5,c5,r5,t3")
    ap.add_argument("--device", default="cuda",
                    help="device of every Solver of the run (default "
                         "cuda; raises without a card; 'cpu' runs the "
                         "plain PyTorch path)")
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help="time-series artifact path ('' disables; a .gz "
                         "suffix gzips — SOAK_r06-scale runs are ~18k "
                         "lines plain; debug.load_timeseries reads both)")
    ap.add_argument("--api-mode", action="store_true",
                    help="drive ALL churn through the fake apiserver "
                         "(watch/list protocol + ApiWriter controllers); "
                         "adds a server-vs-mirror agreement invariant")
    ap.add_argument("--watchers", type=int, default=0,
                    help="extra pods-watch subscribers (API mode only), "
                         "drained by consumer threads — models a fleet "
                         "of dashboards/controllers watching the same "
                         "churn. With snapshot-free fan-out their load "
                         "lands on the delivery layer (watch_event), "
                         "NOT on the api_server store locks; a dropped "
                         "(overrun) watcher re-subscribes like a 410'd "
                         "reflector")
    ap.add_argument("--churn-scale", type=int, default=1,
                    help="multiply pod churn wave sizes (create waves "
                         "become 1-15 x SCALE pods, delete waves up to "
                         "30 x SCALE). In API mode scaled waves ship as "
                         "BULK protocol writes (client.create_pods / "
                         "delete_pods). The exit report prints the "
                         "contention ranking so the api_server lock's "
                         "rank is part of the recorded verdict")
    ap.add_argument("--fault-schedule", default="",
                    help="SECONDS:ACTION[,...] solver fault injections "
                         "(device-error[=N], g-limit=N, b-limit=N, clear)")
    ap.add_argument("--weather", default="",
                    help="adversarial weather scenario: a named scenario "
                         "(calm, squall, spot-crash, ice-age, storm-front) "
                         "or a path to a scenario JSON file "
                         "(docs/reference/weather.md). Composes with "
                         "--fault-schedule; gates the run on the SLO bars "
                         "holding while the ladder is engaged")
    ap.add_argument("--weather-seed", type=int, default=None,
                    help="weather RNG seed (default: --seed); two runs "
                         "with the same scenario+seed record identical "
                         "weather timelines")
    ap.add_argument("--weather-out", default="",
                    help="weather artifact path (default "
                         "WEATHER_gpu_<scenario>.json.gz; '' means "
                         "default)")
    ap.add_argument("--consol-out", default="",
                    help="consolidation artifact path (CONSOL_*.json.gz):"
                         " set, the run FAILS unless the vmapped "
                         "consolidation engine demonstrably engaged — "
                         "accepted removals, >1 candidate set per "
                         "dispatch, zero-leg cache hits, every accept "
                         "refereed — and the savings-per-hour trajectory "
                         "is recorded (docs/reference/consolidation.md)")
    ap.add_argument("--consolidate-after", type=float, default=None,
                    help="enable WhenUnderutilized consolidation on the "
                         "default pool after N seconds of eligibility "
                         "(default: 5 when --consol-out or a spot-crash "
                         "weather scenario is attached, else Never; "
                         "0 forces Never)")
    ap.add_argument("--solver-pool", type=int, default=0,
                    help="spawn N in-process chaos-capable solver "
                         "sidecars on unix sockets and run the operator "
                         "against them as a failover pool "
                         "(parallel/pool.py SolverPool; docs/reference/"
                         "solver-pool.md). Weather SidecarOutage "
                         "elements (the 'blackout' scenario) drive "
                         "kill/hang/junk against these endpoints; the "
                         "run then GATES on failovers > 0, the pool "
                         "recovering (every breaker closed at exit), "
                         "zero solve-error passes, and the local rung "
                         "engaging only under a scripted full blackout")
    ap.add_argument("--standby", action="store_true",
                    help="spawn a live warm-standby operator behind a "
                         "fence-carrying FileLeaseStore lease, fed by "
                         "snapshot + journal-delta replication "
                         "(docs/reference/handoff.md). Requires a "
                         "--weather scenario with OperatorKill elements "
                         "(the 'handoff' scenario) — the run gates on "
                         "the standby promoting within the lease window "
                         "and carrying passes across the cutover")
    ap.add_argument("--solver-solve-deadline", type=float, default=5.0,
                    help="solve RPC deadline against pool endpoints "
                         "(seconds; --solver-pool only). 5 s bounds a "
                         "hung endpoint's cost per pass in a wall-clock "
                         "soak while leaving room for a cold first "
                         "solve of a bucket (run --warm-start to take "
                         "those out of the run)")
    ap.add_argument("--compile-cache-dir", default="",
                    help="build and load the kernel libraries and the "
                         "native referee in this directory "
                         "(solver/solve.py enable_persistent_compile_cache)"
                         "; with --warm-start the ladder builds them first "
                         "and records each shape's analysis")
    ap.add_argument("--warm-start", action="store_true",
                    help="run the warm bucket ladder on the device on a "
                         "background thread at boot and hold the SLO "
                         "warmup window open until it finishes — the "
                         "cold first pass then cannot spike the "
                         "latency burn (peak burn printed at exit)")
    ap.add_argument("--pipeline", action="store_true",
                    help="exercise the overlapped solve path "
                         "(docs/concepts/performance.md 'Pipelining & the "
                         "tunnel link') under sustained load: force the "
                         "pipelined path on and FAIL the soak if it never "
                         "engaged (async solves / resident-cache counters)")
    ap.add_argument("--mesh", default="",
                    help="device mesh for the sharded production path "
                         "(docs/reference/sharding.md; '' = auto, an "
                         "integer forces an N-way mesh, its shards "
                         "batched on --device). Set, the soak "
                         "FAILS unless sharded solves actually carried "
                         "passes (mesh_solves > 0)")
    ap.add_argument("--api-watch-queue-bound", type=int, default=0,
                    help="tighten the per-watcher watch queue bound "
                         "(API mode; 0 = the Options default, 8192). "
                         "Set, the soak parks ONE deliberately idle "
                         "pods watcher whose queue fills at the churn "
                         "event rate, and the exit verdict GATES on the "
                         "headroom forecaster ranking api_watch_queues "
                         "first-to-break BEFORE its first overflow "
                         "(docs/reference/headroom.md) — the "
                         "observatory must predict the break, not "
                         "narrate it")
    ap.add_argument("--headroom-out", default="",
                    help="headroom artifact path (HEADROOM_*.json.gz): "
                         "the final ranked first-to-break table, the "
                         "per-sample saturation trajectory, and the "
                         "forecast-vs-overflow timestamps. The "
                         "no-unexplained-saturation verdict itself "
                         "gates EVERY soak, artifact or not")
    args = ap.parse_args(argv)
    # every gate that failed, in order: printed as it fails, recorded in
    # the weather artifact and printed as one JSON line at the end
    failed_gates = []

    def gate_failed(msg: str) -> None:
        print(msg)
        failed_gates.append(msg)

    from ..device import resolve_device
    resolve_device(args.device)
    fault_schedule = parse_fault_schedule(args.fault_schedule)

    fams = tuple(args.families.split(","))
    lattice = build_lattice([s for s in build_catalog() if s.family in fams])
    q = FakeQueue("soak-q")
    api_server = client = None
    if args.api_mode:
        from ..kube import FakeAPIServer, KubeClient
        from ..kube.apiserver import NotFoundError as KubeNotFound
        api_server = FakeAPIServer()
        client = KubeClient(api_server)
    chaos_sidecars = []
    solver_address = ""
    if args.solver_pool:
        # N chaos-capable sidecars in THIS process (own Solver each, on
        # --device) — the weather simulator's SidecarOutage seam
        # and the pool's failover ladder run against real gRPC endpoints
        import tempfile
        from ..parallel.sidecar import ChaosSidecar
        from ..solver import Solver as _Solver
        pool_dir = tempfile.mkdtemp(prefix="soak-pool-")
        for n in range(args.solver_pool):
            sc = ChaosSidecar(_Solver(lattice, device=args.device),
                              f"unix:{pool_dir}/sidecar{n}.sock").start()
            chaos_sidecars.append(sc)
        solver_address = ",".join(s.address for s in chaos_sidecars)
        print(f"soak: solver pool of {args.solver_pool} sidecars "
              f"({solver_address})")
    opt_extra = {}
    if args.api_watch_queue_bound:
        opt_extra["api_watch_queue_bound"] = args.api_watch_queue_bound
    op = Operator(options=Options(registration_delay=0.2,
                                  batch_idle_duration=0.05,
                                  batch_max_duration=0.5,
                                  interruption_queue="soak-q",
                                  spot_to_spot_consolidation=True,
                                  mesh=args.mesh,
                                  **opt_extra,
                                  solver_address=solver_address,
                                  solver_solve_deadline=(
                                      args.solver_solve_deadline
                                      if args.solver_pool else 0.0),
                                  compile_cache_dir=args.compile_cache_dir),
                  lattice=lattice, interruption_queue=q,
                  api_server=api_server, device=args.device)
    if args.pipeline:
        op.solver.set_pipeline(True)
    if args.warm_start:
        # the SLO warmup window stays open until the AOT ladder lands:
        # cold-compile passes are boot cost, not burn signal
        op.slo.begin_warmup()
        op.solver.warmup(node_pools_count=len(op.node_pools),
                         background=True,
                         aot=bool(args.compile_cache_dir),
                         on_done=op.slo.end_warmup)
    # ---- warm standby (--standby): a second operator behind the lease --
    op_a = op
    op_b = replica = elector_a = elector_b = None
    repl_server = repl_client = handle_a = None
    if args.standby:
        if not args.weather:
            print("soak: --standby without a --weather scenario scripting "
                  "operator kills would be vacuous (nothing ever kills "
                  "the leader)")
            return 1
        import tempfile as _tempfile
        from ..operator.leaderelection import (
            FileLeaseStore, LeaderElector)
        from ..state.replication import (
            ReplicationClient, ReplicationService, ReplicationSource,
            StandbyReplica, serve_replication)
        handoff_dir = _tempfile.mkdtemp(prefix="soak-handoff-")
        repl_src = ReplicationSource(op.cluster)
        repl_server = serve_replication(ReplicationService(repl_src),
                                        f"unix:{handoff_dir}/repl.sock")
        lease_store = FileLeaseStore(f"{handoff_dir}/lease.json")
        # the standby shares the WORLD (clock, cloud, queue, lattice) but
        # owns its mirror: state arrives ONLY over the replication stream
        op_b = Operator(options=Options(registration_delay=0.2,
                                        batch_idle_duration=0.05,
                                        batch_max_duration=0.5,
                                        spot_to_spot_consolidation=True),
                        lattice=lattice, cloud=op.cloud, clock=op.clock,
                        interruption_queue=q, device=args.device)
        repl_client = ReplicationClient(f"unix:{handoff_dir}/repl.sock")
        replica = StandbyReplica(
            op_b.cluster, repl_client,
            prebuild=lambda: op_b.provisioner.warm_build())
        elector_a = LeaderElector(lease_store, "op-a", clock=op.clock)
        elector_b = LeaderElector(lease_store, "op-b", clock=op.clock,
                                  promotion_gate=replica.promotion_ready)
        # introspection is a process-global replace-by-name registry:
        # op_b's construction just claimed every surface, so hand them
        # back to the LEADER (op_b's promote hook re-wires on cutover);
        # wire_handoff order matters for the same reason — standby first,
        # leader last
        op_b.wire_handoff(elector_b, replica=replica)
        op._wire_introspection()
        op.wire_handoff(elector_a, source=repl_src)
        print(f"soak: warm standby armed (lease store "
              f"{handoff_dir}/lease.json, replication "
              f"unix:{handoff_dir}/repl.sock)")
    weather_sim = None
    if args.weather:
        from .. import introspect
        from ..weather import (WeatherSimulator,
                                                        load_scenario)
        scenario = load_scenario(args.weather)
        if args.standby and not scenario.operator_kills:
            print(f"soak: --standby but scenario {scenario.name!r} "
                  "scripts no operator kills — the standby would idle "
                  "the whole run (vacuous handoff)")
            return 1
        if scenario.operator_kills and not args.standby:
            print("soak: scenario scripts operator kills but no "
                  "--standby is attached — killing the only operator "
                  "would just end the control plane")
            return 1
        if args.standby:
            # the runtime the handle crash-stops is created below; the
            # simulator only fires kills after start(), by which point
            # the handle is armed
            handle_a = OperatorHandle(None)
        weather_sim = WeatherSimulator(
            scenario, lattice,
            seed=(args.seed if args.weather_seed is None
                  else args.weather_seed),
            clock=op.clock, pricing=op.pricing_provider, cloud=op.cloud,
            unavailable=op.unavailable, queue=q, solver=op.solver,
            metrics=op.metrics, sidecars=chaos_sidecars,
            operators=([handle_a] if handle_a is not None else None))
        if scenario.sidecar_outages and not chaos_sidecars:
            print("soak: scenario scripts sidecar outages but no "
                  "--solver-pool is attached — the control-plane "
                  "weather would be vacuous")
            return 1
        introspect.registry().register("weather", weather_sim.stats)
        # voluntary consolidation rides the weather: hold through storm
        # windows and crash regimes, keep packing through ice
        # (docs/reference/consolidation.md "Weather gates")
        op.disruption.engine.weather_advisory = \
            weather_sim.consolidation_advisory
        if op_b is not None:
            op_b.disruption.engine.weather_advisory = \
                weather_sim.consolidation_advisory
        print(f"soak: weather scenario {scenario.name!r} "
              f"seed={weather_sim.seed} tick={scenario.tick_seconds}s "
              f"(storms={len(scenario.storms)} ice={len(scenario.ice)} "
              f"regimes={len(scenario.regimes)})")
    # consolidation enablement: the pool default is Never; the CONSOL
    # verdict and the spot-crash advisory gate both need the engine live
    from ..weather.simulator import CONSOL_HOLD_MU
    crash_scripted = (weather_sim is not None and any(
        r.mu >= CONSOL_HOLD_MU for r in weather_sim.scenario.regimes))
    consolidate_after = args.consolidate_after
    if consolidate_after is None and (args.consol_out or crash_scripted):
        # short enough that storm-churned nodes still age into
        # eligibility mid-window — 15 s leaves the candidate set empty
        # through an interruption storm and the weather gate vacuous
        consolidate_after = 5.0
    if consolidate_after:
        for o in (op, op_b):
            if o is None:
                continue
            dflt = o.node_pools.get("default")
            if dflt is not None:
                dflt.disruption.consolidation_policy = "WhenUnderutilized"
                dflt.disruption.consolidate_after = consolidate_after
                if client is not None and o is op:
                    client.update_nodepool(dflt)   # API mode: via watch
        print(f"soak: consolidation armed (WhenUnderutilized, "
              f"consolidate_after={consolidate_after}s)")
    specs_a = operator_specs(op)
    if consolidate_after:
        # one voluntary disruption per pass at the default 10 s cadence
        # starves the consolidation verdict on a minutes-long soak —
        # emptiness alone eats every pass. Same controller, just paced
        # to the soak's churn tempo.
        for sp in specs_a:
            if sp.name == "disruption":
                sp.interval = 2.0
    rt = ControllerRuntime(specs_a, elector=elector_a).start()
    rt_b = None
    if args.standby:
        handle_a.runtime = rt
        from ..operator.runtime import \
            ControllerSpec
        specs_b = operator_specs(op_b)
        # the replication pump runs UNGATED (standbys stream; leaders
        # don't poll themselves) and goes quiet on promotion
        specs_b.append(ControllerSpec(
            "handoff-sync",
            lambda: (replica.sync_once()
                     if not elector_b.is_leader else None),
            interval=0.2, gate_on_leadership=False))
        rt_b = ControllerRuntime(specs_b, elector=elector_b).start()
    from ..debug import Monitor, dump_state
    monitor = Monitor(op).start(interval=1.0)
    # the extra watcher fleet: N pods subscriptions drained by a few
    # consumer threads (kube/apiserver.py bounded queues + 410/relist)
    import threading as _threading
    watch_stats = {"delivered": 0, "resubscribes": 0}
    watch_stop = _threading.Event()
    watch_threads = []
    if args.watchers and api_server is not None:
        from ..kube.apiserver import TooOldError

        def drain(watch_slice):
            subs = [api_server.watch("pods") for _ in range(watch_slice)]
            delivered = resubs = 0
            while not watch_stop.is_set():
                for i, w in enumerate(subs):
                    try:
                        delivered += len(w.pop_pending())
                    except TooOldError:
                        api_server.stop_watch(w)
                        subs[i] = api_server.watch("pods",
                                                   api_server.last_rv)
                        resubs += 1
                watch_stop.wait(0.05)
            for w in subs:
                api_server.stop_watch(w)
            watch_stats["delivered"] += delivered
            watch_stats["resubscribes"] += resubs

        n_drainers = min(2, args.watchers)
        per = max(args.watchers // n_drainers, 1)
        watch_threads = [
            _threading.Thread(target=drain, args=(per,), daemon=True,
                              name=f"soak-watcher-{i}")
            for i in range(n_drainers)]
        for t in watch_threads:
            t.start()
    # the deliberately idle watcher (--api-watch-queue-bound): never
    # drained, so its queue fills at the raw churn event rate. The
    # drained fleet above never shows the forecaster a rising depth —
    # THIS queue is the one the prediction-before-overflow gate reads
    idle_watch = None
    if args.api_watch_queue_bound and api_server is not None:
        idle_watch = api_server.watch("pods")
        print(f"soak: idle watcher parked against a watch queue bound "
              f"of {args.api_watch_queue_bound} — the headroom "
              "forecaster must name it before it overflows")
    rng = random.Random(args.seed)
    t_start = time.monotonic()
    stop = t_start + args.minutes * 60.0
    i = 0
    pending_faults = list(fault_schedule)
    promote_t = b_first_pass_t = None
    # engine stats frozen at the LAST advisory-held instant: the
    # "savings resumed after the crash" gate compares against these
    consol_stats_at_hold = None

    def safe_instances():
        try:
            return op.cloud.list_instances()
        except Exception:
            return []

    # arm-check the lock-order witness (introspect/contention.py;
    # docs/reference/linting.md): one deliberate benign nesting on
    # dedicated names proves the witness is recording BEFORE the run —
    # the production locks are kept deliberately flat by the out-of-lock
    # discipline, so "0 edges at exit" would otherwise be ambiguous
    # between "nothing nested" and "witness never armed"
    from ..introspect import contention as _cont
    with _cont.lock("soak_witness_outer"):
        with _cont.lock("soak_witness_inner"):
            pass
    assert _cont.lockorder_stats()["edges"] >= 1, \
        "lock-order witness failed its arm-check"
    print("soak: lock-order witness armed "
          "(soak_witness_outer -> soak_witness_inner recorded)")

    if weather_sim is not None:
        weather_sim.start()
    try:
        while time.monotonic() < stop:
            while pending_faults and \
                    time.monotonic() - t_start >= pending_faults[0][0]:
                _, fname, fval = pending_faults.pop(0)
                apply_fault(op.solver, fname, fval)
                print(f"soak: fault applied {fname}"
                      f"{'' if fval is None else '=' + str(fval)}")
            if weather_sim is not None:
                weather_sim.advance()
                if weather_sim.consolidation_advisory()["hold"]:
                    consol_stats_at_hold = op.disruption.engine.stats()
            # churn lands on the ACTIVE operator: after a cutover the
            # promoted standby's mirror is the live one (the dead
            # leader's would silently swallow every wave)
            aop = op
            if args.standby and elector_b.is_leader:
                aop = op_b
                if promote_t is None:
                    promote_t = time.monotonic()
                    print(f"soak: standby PROMOTED (fence "
                          f"{elector_b.fence}) "
                          f"{promote_t - (handle_a.killed_at or promote_t):.1f}s "
                          "after the leader kill")
                if b_first_pass_t is None and \
                        op_b.provisioner.stats().get("passes", 0) > 0:
                    b_first_pass_t = time.monotonic()
            r = rng.random()
            if r < 0.5:
                wave = []
                for _ in range(rng.randint(1, 15) * args.churn_scale):
                    i += 1
                    wave.append(Pod(
                        name=f"s{i}",
                        requests={"cpu": f"{rng.choice([250, 500, 1000, 2000])}m",
                                  "memory": f"{rng.choice([512, 1024, 2048])}Mi"}))
                if client is not None:
                    # through the protocol — one BULK write per wave
                    # (one lock acquisition + one watch flush), the
                    # coalesced ingest path the 100k-churn soak proves
                    client.create_pods(wave)
                else:
                    for pod in wave:
                        aop.cluster.add_pod(pod)
            elif r < 0.8:
                # heavy deletion waves -> underutilized nodes -> consolidation.
                # Bounded at 10% of the population per wave so scaled
                # churn GROWS the cluster instead of strip-mining it —
                # the 100k-churn soak must also hold 100+ nodes under
                # fire, not just cycle a small one fast
                names = list(aop.cluster.pods)
                doomed = rng.sample(
                    names, min(len(names), max(len(names) // 10, 1),
                               rng.randint(5, 30) * args.churn_scale))
                if client is not None:
                    client.delete_pods(doomed)   # NotFound raced = ignored
                else:
                    for name in doomed:
                        aop.cluster.delete_pod(name)
            elif r < 0.88:
                insts = safe_instances()
                if insts:
                    q.send(spot_interruption(rng.choice(insts).id))
            elif r < 0.91:
                # drift churn: rev the pool template; the drift
                # controller must roll stale-hash nodes while the rest
                # of the storm rages (API mode: server-side, so the
                # config watch delivers it like any operator would).
                # With consolidation armed the rev is suppressed: a
                # template revved every second keeps EVERY node
                # perpetually drift-stale, and drift (earlier in the
                # method order) would eat every disruption pass —
                # the consolidation verdict would starve by design.
                pool = (None if consolidate_after
                        else aop.node_pools.get("default"))
                if pool is not None:
                    pool.labels["soak/rev"] = f"r{i}"
                    if client is not None:
                        client.update_nodepool(pool)
            elif r < 0.94:
                op.cloud.inject_error(NotFoundError("soak-chaos"))
            else:
                insts = safe_instances()
                if insts:
                    v = rng.choice(insts)
                    op.cloud.set_capacity(v.capacity_type, v.instance_type,
                                          v.zone, 0)
            time.sleep(rng.uniform(0.01, 0.08))
    finally:
        # a controller blocked mid-pass can outlive the join timeout;
        # invariants must never be read over live mutation
        while not rt.stop():
            print("soak: waiting for a blocked controller thread...")
        if rt_b is not None:
            while not rt_b.stop():
                print("soak: waiting for a blocked standby thread...")
        monitor.stop()
        watch_stop.set()
        for t in watch_threads:
            t.join(timeout=2.0)
        if watch_threads:
            print(f"soak: watcher fleet ({args.watchers}) delivered="
                  f"{watch_stats['delivered']} "
                  f"resubscribes={watch_stats['resubscribes']}")
        if idle_watch is not None:
            # stop_watch folds its depth into the server's monotonic
            # high water; the registry's own high water already holds it
            api_server.stop_watch(idle_watch)

    # the handoff verdict BEFORE any rebind: the gates read both sides
    handoff_ok = True
    handoff_report = None
    if args.standby:
        promoted = elector_b.is_leader or promote_t is not None
        kill_t = handle_a.killed_at
        latency = (promote_t - kill_t) if (promote_t and kill_t) else None
        first_pass = (b_first_pass_t - promote_t) if (b_first_pass_t
                                                      and promote_t) else None
        rs = replica.stats()
        b_passes = op_b.provisioner.stats().get("passes", 0)
        b_deltas = op_b.solver.pipeline_stats.get("delta_solves", 0)
        # duplicate-launch evidence on the SHARED cloud: across both
        # mirrors no provider ID may back two claims (a standby
        # relaunching capacity the dead leader already provisioned
        # would mint a second instance for the same workload)
        # claims replicated to BOTH mirrors legitimately share provider
        # IDs — only collisions WITHIN one mirror are duplicates
        dup_providers = sum(
            len(ps) - len(set(ps)) for ps in (
                [c.provider_id for c in o.cluster.claims.values()
                 if c.provider_id] for o in (op_a, op_b)))
        handoff_report = {
            "promoted": promoted, "fence": elector_b.fence,
            "promote_latency_s": latency, "first_pass_s": first_pass,
            "kill_at_s": (kill_t - t_start) if kill_t else None,
            "standby_passes": b_passes, "standby_delta_solves": b_deltas,
            "replica": rs, "dup_provider_ids": dup_providers,
            "fence_rejections": (op_a._fence_guard.rejections
                                 if op_a._fence_guard else 0),
            "leases_swept": op_b.cluster.leases_swept,
            "promotions_blocked": elector_b.promotions_blocked,
        }
        print(f"soak: handoff {handoff_report}")
        if kill_t is None:
            print("soak: scenario scripted an operator kill but the "
                  "handle never fired (vacuous handoff)")
            handoff_ok = False
        if not promoted:
            print("soak: leader killed but the standby never promoted")
            handoff_ok = False
        if latency is not None and latency > \
                elector_b.lease_duration + 3 * 2.0 + 5.0:
            print(f"soak: promotion took {latency:.1f}s — outside the "
                  "lease window + election cadence")
            handoff_ok = False
        if promoted and first_pass is None:
            print("soak: standby promoted but never carried a "
                  "provisioning pass")
            handoff_ok = False
        elif first_pass is not None and first_pass > 10.0:
            print(f"soak: first post-promotion pass took {first_pass:.1f}s "
                  "(> 10s SLO window)")
            handoff_ok = False
        if promoted and rs.get("prebuilds", 0) == 0:
            # delta solves post-promotion are NOT required: the handoff
            # scenario reprices every tick, and price-changed correctly
            # forces the incremental builder onto the full path — warmth
            # is evidenced by the pre-promotion prebuild stream instead
            print("soak: promoted standby never prebuilt — "
                  "the warm mirror was not actually warm")
            handoff_ok = False
        if promoted and rs.get("snapshots", 0) < 1:
            print("soak: standby promoted without ever applying a "
                  "snapshot")
            handoff_ok = False
        if dup_providers:
            print(f"soak: {dup_providers} duplicate provider IDs across "
                  "the handoff (capacity launched twice)")
            handoff_ok = False
        # hand the exit/convergence machinery the PROMOTED operator: its
        # mirror is the live control plane now. Its runtime released the
        # lease on stop, so re-acquire once — the single-threaded
        # convergence loop below writes through the fence guard.
        if promoted:
            elector_b.try_acquire_or_renew()
            op = op_b
    # converge: clear injected faults (all controller threads have joined,
    # so plain writes are race-free here), then let the single-threaded
    # loop settle PAST the GC grace window so every reapable leak is reaped
    weather_ticks = 0
    if weather_sim is not None:
        # freeze the weather at cutoff: thaw held pools, restore base spot
        # prices (one more price_version bump so downstream memos re-key).
        # The injected device faults clear with the rest below.
        weather_ticks = weather_sim.ticks
        weather_sim.stop()
    op.cloud.next_error = None
    op.cloud.capacity_pools.clear()
    # capacity is restored — flush the ICE marks with it (their 180 s
    # TTL would otherwise mask offerings deep into the convergence tail
    # and strand late-wave pods as unschedulable)
    op.unavailable.flush()
    # quiesce VOLUNTARY disruption for the invariant read: consolidation
    # is a continuous optimizer — on a churn-scaled multi-thousand-pod
    # cluster it drains/rebinds pods indefinitely, and a single-instant
    # "zero pending" is about involuntary state, not about catching the
    # optimizer between a drain and its rebind. Termination/GC keep
    # running so every in-flight drain still completes.
    if consolidate_after:
        # the zero-leg coda: the cache's steady-state claim needs a calm
        # instant the storm never offers. Budget pinned to 0 so nothing
        # moves; one search repopulates the probe cache (the ICE flush
        # above invalidated it), then a pending-only wiggle re-runs the
        # search — every candidate verdict must come back cached, at
        # zero device legs (docs/reference/consolidation.md)
        from ..apis.objects import \
            DisruptionBudget
        dflt = op.node_pools.get("default")
        if dflt is not None:
            dflt.disruption.budgets = [DisruptionBudget(nodes="0")]
            # churn-fresh replacements are younger than consolidate_after
            # at cutoff; the coda is about the cache, not pacing, so make
            # every initialized node eligible for the search
            dflt.disruption.consolidate_after = 0.0
        # finish whatever the storm left mid-flight — draining originals,
        # unregistered replacements, evicted pods re-pending all keep
        # dirtying bins pass after pass; the coda needs a genuinely calm
        # cluster, and budget 0 keeps anything NEW from starting
        calm, calm_deadline = 0, time.monotonic() + 25.0
        while time.monotonic() < calm_deadline:
            op.run_once()
            if not op.cluster.pending_pods() \
                    and not op.disruption._in_flight:
                calm += 1
                if calm >= 5:
                    break
            else:
                calm = 0
            time.sleep(0.05)
        for _ in range(8):
            if not op.disruption._reconcile_once():
                break
        pre_coda = post_coda = op.disruption.engine.stats()
        for attempt in range(3):
            wiggle = f"consol-coda-{attempt}"
            op.cluster.add_pod(Pod(name=wiggle,
                                   requests={"cpu": "100m",
                                             "memory": "64Mi"}))
            op.disruption._reconcile_once()
            op.cluster.delete_pod(wiggle)
            post_coda = op.disruption.engine.stats()
            if post_coda.get("fp_unchanged", 0) > \
                    pre_coda.get("fp_unchanged", 0):
                break
        print(f"soak: consolidation coda zero-leg hits "
              f"{pre_coda.get('fp_unchanged', 0):g} -> "
              f"{post_coda.get('fp_unchanged', 0):g} "
              f"(dispatches {pre_coda.get('vmapped_whatifs', 0):g} -> "
              f"{post_coda.get('vmapped_whatifs', 0):g})")
    op.disruption.reconcile = lambda: None
    solver_fired = dict(op.solver.faults.fired) if op.solver.faults else {}
    op.solver.inject_faults(None)
    # scaled churn leaves a 10k-pod cluster mid-wave at cutoff; the
    # convergence tail gets proportionally longer so the verdict is
    # about invariants, not about how fast a big cluster can settle
    tail = LEAK_GRACE_SECONDS + 15.0 + (60.0 if args.churn_scale > 1
                                        else 0.0)
    deadline = time.monotonic() + tail
    ticks = 0
    while time.monotonic() < deadline:
        op.run_once()
        ticks += 1
        if ticks % 20 == 0:
            monitor.sample()   # the convergence tail rides the series too
        if not op.cluster.pending_pods() \
                and time.monotonic() > deadline - 10.0:
            break
        time.sleep(0.05)
    monitor.sample()

    pending = op.cluster.pending_pods()
    if pending:
        # name WHY the tail could not settle: the provisioner's last-pass
        # verdict plus a sample of the stuck pods
        print(f"soak: last pass = "
              f"{ {k: v for k, v in op.provisioner.stats().items() if k.startswith('last_pass')} } "
              f"sample stuck: {[p.name for p in pending[:5]]}")
    claimed = {c.provider_id for c in op.cluster.claims.values()
               if c.provider_id}
    leaked = [x for x in op.cloud.list_instances()
              if x.provider_id not in claimed]
    orphans = op.cluster.orphaned_leases()
    print(f"soak: pods_churned={i} pending={len(pending)} "
          f"nodes={len(op.cluster.nodes)} claims={len(op.cluster.claims)} "
          f"leaked={len(leaked)} orphan_leases={len(orphans)}")
    if fault_schedule:
        print(f"soak: solver degraded_counts={op.solver.degraded_counts} "
              f"faults_fired={solver_fired}")
    ok = not pending and not leaked and not orphans
    for what, n in (("pending pods", len(pending)),
                    ("leaked instances", len(leaked)),
                    ("orphaned leases", len(orphans))):
        if n:
            failed_gates.append(f"soak: {n} {what} after convergence")
    if args.standby:
        ok = ok and handoff_ok
        if not handoff_ok:
            failed_gates.append("soak: the handoff gates failed")
    if args.pipeline:
        # the overlapped path must have actually carried the soak's
        # solves — a flag that silently fell back to sequential would
        # report a vacuous pass
        pstats = dict(op.solver.pipeline_stats)
        cstats = op.solver._resident.stats()
        print(f"soak: pipeline stats={pstats} resident_cache={cstats}")
        if pstats.get("async_solves", 0) == 0:
            gate_failed("soak: --pipeline set but no solve took the "
                  "overlapped path")
            ok = False
    if fault_schedule and not (op.solver.degraded_counts or solver_fired):
        # a schedule that never fired means the soak did not exercise the
        # ladder it promised to — fail loudly rather than report a
        # vacuous pass
        gate_failed("soak: fault schedule applied but solver never degraded")
        ok = False
    if client is not None:
        # server-vs-mirror agreement: after convergence the watch-fed
        # mirror and the apiserver's truth must be identical sets
        op.sync_once()
        server_pods = {p.name for p in client.list_pods()}
        server_nodes = {n.name for n in client.list_nodes()}
        agree = (server_pods == set(op.cluster.pods)
                 and server_nodes == set(op.cluster.nodes))
        print(f"soak: server-vs-mirror agreement "
              f"{'OK' if agree else 'VIOLATED'} "
              f"(pods {len(server_pods)}, nodes {len(server_nodes)})")
        if not agree:
            ps, pm = server_pods - set(op.cluster.pods), \
                set(op.cluster.pods) - server_pods
            ns, nm = server_nodes - set(op.cluster.nodes), \
                set(op.cluster.nodes) - server_nodes
            print(f"soak: agreement diff: pods server-only "
                  f"{sorted(ps)[:5]} (+{max(len(ps) - 5, 0)}) "
                  f"mirror-only {sorted(pm)[:5]} (+{max(len(pm) - 5, 0)}); "
                  f"nodes server-only {sorted(ns)[:5]} "
                  f"mirror-only {sorted(nm)[:5]}")
        ok = ok and agree
        if not agree:
            failed_gates.append("soak: server-vs-mirror agreement violated")
    # the SLO burn verdict over the whole run (introspect/slo.py — the
    # same gauges /metrics exports and the Monitor artifact carries)
    slo = op.slo.update()
    print(f"soak: slo latency_burn={slo['latency_burn']} "
          f"(p50 {slo['latency_p50_ms']}ms / 200ms) "
          f"cost_burn={slo['cost_burn']} "
          f"(ratio_p50 {slo['cost_ratio_p50']})")
    weather_doc = None
    if weather_sim is not None:
        from ..weather import WeatherSimulator as _WS
        wsc = weather_sim.scenario
        wstats = weather_sim.stats()
        if args.standby:
            # the storm straddles the cutover: A consumed messages before
            # the kill, B after promotion — the evidence bar sums both
            intr = {}
            for o in (op_a, op_b):
                if o is None or o.interruption is None:
                    continue
                for k, v in o.interruption.stats().items():
                    intr[k] = intr.get(k, 0) + v
        else:
            intr = op.interruption.stats() if op.interruption else {}
        # real interruption schemas only — junk (malformed/unknown) is
        # counted separately and must not pad the >100 evidence bar
        handled = sum(intr.get(f"received_{k}", 0)
                      for k in ("spot_interruption",
                                "rebalance_recommendation",
                                "scheduled_change", "state_change"))
        degraded_total = sum(op.solver.degraded_counts.values())
        # the replay check: the deterministic timeline must re-derive
        # byte-identically from (scenario, seed, ticks) with no control
        # plane attached — the recorded weather was reproducible, not
        # anecdotal
        replay_match = (_WS.replay(wsc, lattice, weather_ticks,
                                   seed=weather_sim.seed)
                        == weather_sim.timeline)
        print(f"soak: weather ticks={weather_ticks} "
              f"events={len(weather_sim.timeline)} "
              f"msgs={wstats['messages_sent']} "
              f"(junk {wstats['junk_sent']}) "
              f"ice_marks={wstats['ice_marks']} "
              f"device_errors={wstats['device_errors']} "
              f"interruptions_handled={handled} "
              f"degraded_total={degraded_total} "
              f"replay={'IDENTICAL' if replay_match else 'DIVERGED'}")
        # the weather gates: the paper's bars must hold WHILE the ladder
        # is engaged and the market moves (burn thresholds per ISSUE 9 /
        # ROADMAP item 5), and the chaos must be demonstrably non-vacuous
        if not replay_match:
            gate_failed("soak: weather timeline is not same-seed reproducible")
            ok = False
        if slo["latency_burn"] >= 1.0:
            gate_failed(f"soak: sustained latency burn {slo['latency_burn']} "
                  ">= 1.0 under weather")
            ok = False
        if slo["cost_burn"] > 1.0:
            gate_failed(f"soak: cost burn {slo['cost_burn']} > 1.0 "
                  "(>2% vs FFD referee) under weather")
            ok = False
        if wsc.storms:
            if handled <= 100:
                gate_failed(f"soak: weather storms configured but only {handled} "
                      "interruption messages handled (> 100 required)")
                ok = False
            # the storms themselves must have produced evidence: the
            # churn loop's own ad-hoc spot interruptions also land in
            # `handled`, so a run whose scripted storms never fired (too
            # short, or zone filters matching nothing) must not pass on
            # churn-generated padding
            storm_real = wstats["messages_sent"] - wstats["junk_sent"]
            if wstats["storm_ticks"] == 0 or storm_real == 0:
                gate_failed(f"soak: weather storms configured but produced no "
                      f"storm-sourced messages (storm_ticks="
                      f"{wstats['storm_ticks']}, real msgs={storm_real})")
                ok = False
            if any(s.device_error_rate for s in wsc.storms) \
                    and degraded_total == 0:
                gate_failed("soak: weather device faults configured but the "
                      "solver never degraded")
                ok = False
        # the same non-vacuity bar for the other weather systems: a
        # scenario that scripts ICE spells or regime shifts must have
        # actually applied them (a run shorter than the schedule, or
        # filters matching no offering, must not read as a survived
        # scarcity/price drill)
        if wsc.ice and wstats["ice_marks"] == 0:
            gate_failed("soak: weather ICE spells configured but no offering "
                  "was ever held (ice_marks=0)")
            ok = False
        if wsc.regimes and wstats["regime_shifts"] == 0:
            gate_failed("soak: weather regimes configured but none activated "
                  "(regime_shifts=0)")
            ok = False
        # the consolidation weather gate must be NON-VACUOUS on a crash
        # scenario (docs/reference/consolidation.md "Weather gates"):
        # holds demonstrably recorded DURING the crash window, and the
        # engine demonstrably resuming (savings growing) after it
        # cleared — a run that merely never consolidated proves nothing
        if crash_scripted:
            cst = op.disruption.engine.stats()
            held = cst.get("weather_holds", 0)
            hold_skips = cst.get("skip_consolidation_weather_hold", 0)
            print(f"soak: consolidation weather gate holds={held:g} "
                  f"hold_skips={hold_skips:g} "
                  f"savings_at_last_hold="
                  f"{(consol_stats_at_hold or {}).get('savings_per_hour')} "
                  f"savings_final={cst.get('savings_per_hour', 0.0):g}")
            if held == 0 or hold_skips == 0:
                gate_failed("soak: a spot-crash regime was scripted but "
                      "consolidation never recorded a weather hold "
                      "(vacuous gate — was the engine ever eligible "
                      "during the window?)")
                ok = False
            if consol_stats_at_hold is None:
                gate_failed("soak: crash regime scripted but the advisory "
                      "never reported hold to the churn loop")
                ok = False
            elif cst.get("savings_per_hour", 0.0) <= \
                    consol_stats_at_hold.get("savings_per_hour", 0.0) \
                    + 1e-9:
                gate_failed("soak: consolidation never RESUMED after the "
                      "crash window (savings flat since the last hold)")
                ok = False
        # control-plane weather gates (docs/reference/solver-pool.md):
        # a blackout drill must demonstrably have exercised the pool —
        # failovers happened, the local rung engaged ONLY under a
        # scripted full blackout, no pass was lost to a solve error,
        # and the pool RECOVERED (every breaker closed again after the
        # outage windows + convergence tail)
        if wsc.sidecar_outages and chaos_sidecars:
            # give the breakers their probation: the half-open probe
            # rides the injected clock (wall time here), and repeated
            # opens back off up to ~30 s — poll until every endpoint is
            # closed again or the recovery budget runs out
            recover_deadline = time.monotonic() + 45.0
            while time.monotonic() < recover_deadline:
                op.solver.check_endpoints()
                pst = op.solver.pool_stats()
                if pst["healthy"] == pst["endpoints"]:
                    break
                time.sleep(0.5)
            pst = op.solver.pool_stats()
            full_blackout = full_blackout_scripted(wsc,
                                                   len(chaos_sidecars))
            print(f"soak: pool endpoints={pst['endpoints']} "
                  f"healthy={pst['healthy']} "
                  f"failovers={pst['failovers']} "
                  f"delegated={pst['delegated_solves']} "
                  f"local={pst['local_solves']} "
                  f"breakers="
                  + ",".join(op.solver.breaker_states().values()))
            if pst["failovers"] == 0:
                gate_failed("soak: sidecar outages scripted but the pool "
                      "never failed over (failovers=0)")
                ok = False
            if pst["healthy"] != pst["endpoints"]:
                gate_failed("soak: pool did not recover after the outage "
                      f"window ({pst['healthy']}/{pst['endpoints']} "
                      "breakers closed)")
                ok = False
            if full_blackout and pst["local_solves"] == 0:
                gate_failed("soak: a full blackout was scripted but the "
                      "local rung never engaged (local_solves=0)")
                ok = False
            if not full_blackout and pst["local_solves"] > 0:
                gate_failed(f"soak: local rung engaged {pst['local_solves']}x "
                      "without a scripted full blackout (a healthy "
                      "endpoint existed the whole run)")
                ok = False
            solve_errors = op.provisioner.explain.stats().get(
                "reason_solve_error", 0)
            if solve_errors:
                gate_failed(f"soak: {solve_errors:g} passes lost to "
                      "solve-error under control-plane weather")
                ok = False
        t_base = monitor.samples[0]["t"] if monitor.samples else 0.0
        burn_series = [
            [round(s["t"] - t_base, 1),
             s["subsystems"]["slo"].get("latency_burn", 0.0),
             s["subsystems"]["slo"].get("cost_burn", 0.0)]
            for s in monitor.samples if "slo" in s.get("subsystems", {})]
        weather_doc = weather_sim.artifact(
            slo=slo, burn_series=burn_series,
            degraded_counts=dict(op.solver.degraded_counts),
            solver_faults_fired=solver_fired,
            solver_pool=(op.solver.pool_stats()
                         if chaos_sidecars else None),
            interruption=intr, interruptions_handled=handled,
            replay_match=replay_match,
            handoff=(handoff_report if args.standby else None),
            soak={"pods_churned": i, "minutes": args.minutes,
                  "seed": args.seed, "api_mode": bool(args.api_mode),
                  "churn_scale": args.churn_scale,
                  "device": str(op.solver.device),
                  "kernel_launches": offering_argmin.LAUNCHES,
                  "pending": len(pending), "leaked": len(leaked),
                  "orphan_leases": len(orphans)})
    # ONE summary pass serves every exit print below (summary() rescans
    # all retained samples, including the per-sample contention sweep)
    summ = monitor.summary()
    print(f"soak: incremental builds="
          f"{op.provisioner.inc_builder.incremental_builds} "
          f"full={op.provisioner.inc_builder.full_builds} "
          f"delta_solves={op.solver.pipeline_stats['delta_solves']} "
          f"peak_latency_burn={summ.get('peak_latency_burn')}")
    if "peak_lock_wait_ms" in summ:
        print(f"soak: peak lock wait {summ['peak_lock_wait_ms']}ms "
              f"({summ.get('peak_lock_wait_lock')}) "
              f"burn_captures={op.burn_capture.stats().get('total', 0)}")
    # the contention verdict (introspect/contention.py; what `kpctl top`
    # CONTENTION renders): top-3 locks by wait p99 — the write-path
    # acceptance for the API stratum is api_server OUT of this list
    from ..introspect import contention
    top3 = contention.top_waits(3)
    print("soak: contention top3 = "
          + (", ".join(f"{n} p99={p * 1e3:.2f}ms ({c}x)"
                       for n, p, c in top3) or "(none contended)"))
    print("soak: contention full ranking = "
          + (", ".join(f"{n} p99={p * 1e3:.2f}ms ({c}x)"
                       for n, p, c in contention.top_waits(10))
             or "(none)"))
    # the lock-order witness verdict (introspect/contention.py;
    # docs/reference/linting.md): a threaded run must have WITNESSED
    # orderings (edges > 0 — a zero-edge run means the witness never
    # armed, a vacuous pass) and found NO cycle (a cycle is a potential
    # deadlock two threads can complete any day)
    lo = contention.lockorder_stats()
    lo_cycles = contention.lockorder_cycles()
    lo_edges = contention.lockorder_detail()["edges"]
    prod_edges = [e for e in lo_edges
                  if not e.startswith("soak_witness")]
    print(f"soak: lockorder edges={lo['edges']:g} "
          f"(production {len(prod_edges)}: {sorted(prod_edges)}) "
          f"cycles={len(lo_cycles)} "
          f"ordered_acquires={lo['ordered_acquires']:g}")
    if lo["edges"] == 0:
        # the arm-check edge alone guarantees >= 1: zero means the
        # witness machinery itself stopped recording mid-run
        gate_failed("soak: lock-order witness recorded no edges — witness "
              "disarmed (even the arm-check edge is gone)")
        ok = False
    if lo_cycles:
        import json as _json
        gate_failed("soak: LOCK-ORDER CYCLES (potential deadlock):")
        for cyc in contention.lockorder_detail()["cycles"]:
            print(_json.dumps(cyc, indent=1))
        ok = False
    if client is not None:
        api_ranked = any(n == "api_server" for n, _, _ in top3)
        print(f"soak: api_server in contention top-3: "
              f"{'YES' if api_ranked else 'no'} "
              f"(bulk_ops={api_server.bulk_ops}, "
              f"watch_drops={api_server.stats()['watch_drops']}, "
              f"bookmarks={api_server.bookmarks_sent}, "
              f"fanout_copies={api_server.fanout_envelope_copies})")
        api_doc = contention.detail()["locks"].get("api_server", {})
        print(f"soak: api_server owners-at-contention = "
              f"{api_doc.get('ownersAtContention', {})} "
              f"(contended {api_doc.get('contended', 0)}, "
              f"maxWaitMs {api_doc.get('maxWaitMs', 0)}, "
              f"maxHoldMs {api_doc.get('maxHoldMs', 0)})")
    # the per-pass reason-code histogram (solver/explain.py; the
    # "explain" provider's reason_* counters ride every monitor sample,
    # so the artifact embeds the full time series) — the exit report
    # prints the final tally so a weather run's pending pods are
    # attributable at a glance
    ex_stats = op.provisioner.explain.stats()
    reasons = {k[len("reason_"):].replace("_", "-"): v
               for k, v in ex_stats.items()
               if k.startswith("reason_") and v > 0}
    print(f"soak: explain passes={ex_stats.get('passes', 0):g} "
          f"reason histogram: "
          + (" ".join(f"{k}={v:g}" for k, v in sorted(reasons.items()))
             or "(no unschedulable pods)"))
    # the mesh verdict (docs/reference/sharding.md): with a mesh
    # requested, sharded solves must actually have carried passes — a
    # planner silently falling back to single-device must not read as a
    # survived mesh soak
    sst = op.solver.stats()
    print(f"soak: mesh devices={sst.get('mesh_devices', 1):g} "
          f"sharded_solves={sst.get('mesh_solves', 0):g} "
          f"imbalance={sst.get('mesh_shard_imbalance', 0.0):g}")
    # same normalization as plan_mesh: only a FORCING spec arms the
    # gate — "auto" legitimately plans single-device on the cpu backend
    mesh_spec = (args.mesh or "").strip().lower()
    if mesh_spec and mesh_spec not in ("auto", "off", "none", "single", "1"):
        if sst.get("mesh_devices", 1) <= 1 or sst.get("mesh_solves", 0) == 0:
            gate_failed(f"soak: --mesh {args.mesh} requested but the sharded "
                  "path never carried a pass (mesh_devices="
                  f"{sst.get('mesh_devices')}, "
                  f"mesh_solves={sst.get('mesh_solves')})")
            ok = False
    if args.warm_start:
        peak = summ.get("peak_latency_burn", 0.0) or 0.0
        if peak >= 2.0:
            # the satellite's regression bar: with AOT warmup active a
            # cold-compile first pass must not read as an SLO burn spike
            # (SOAK_r06 recorded ~8 without it)
            gate_failed(f"soak: --warm-start set but peak latency burn {peak} "
                  ">= 2.0 (cold-compile spike leaked into the SLO window)")
            ok = False
    if args.out:
        monitor.write(args.out)
        print(f"soak: time series -> {args.out} "
              f"({len(monitor.samples)} samples, "
              f"peak_nodes={summ.get('peak_nodes')}, "
              f"peak_cost/hr={summ.get('peak_cost_per_hour')}, "
              f"peak_latency_burn={summ.get('peak_latency_burn')})")
    if weather_doc is not None:
        import gzip
        import json
        weather_doc["invariants_ok"] = ok
        weather_doc["failed_gates"] = list(failed_gates)
        wout = args.weather_out or \
            f"WEATHER_gpu_{weather_sim.scenario.name.replace('-', '_')}.json.gz"
        if wout.endswith(".gz"):
            with gzip.open(wout, "wt") as f:
                json.dump(weather_doc, f, separators=(",", ":"))
        else:
            with open(wout, "w") as f:
                json.dump(weather_doc, f, indent=1)
        print(f"soak: weather artifact -> {wout} "
              f"({len(weather_doc['timeline'])} timeline events, "
              f"{len(weather_doc['burn_series'])} burn samples)")
    # ---- the saturation verdict (docs/reference/headroom.md) ----------
    # Gated on EVERY soak: the final first-to-break table prints, and
    # any queue-kind resource whose monotonic high water reached its
    # capacity must be EXPLAINED — by the weather scenario or by a
    # deliberately tightened --api-watch-queue-bound — or the run
    # fails. "The bound worked, silently" is exactly the failure mode
    # the observatory exists to end.
    hr_rows = op.headroom.table()
    hr_sum = op.headroom.stats()
    print(f"soak: headroom first-to-break table (top 5 of "
          f"{len(hr_rows)}):")
    for row in hr_rows[:5]:
        tte = row["seconds_to_exhaustion"]
        print(f"soak:   {row['resource']:<26} {row['kind']:<5} "
              f"depth={row['depth']:g}/{row['capacity']:g} "
              f"hw={row['highwater']:g} drops={row['drops']:g} "
              f"occ={row['occupancy']:.2f} "
              f"tte={'-' if tte is None else format(tte, '.1f') + 's'}")
    print(f"soak: headroom saturated={hr_sum['saturated']:g} "
          f"episodes={hr_sum['episodes']:g} "
          f"probe_errors={hr_sum['probe_errors']:g} "
          f"first_to_break={hr_sum['first_to_break'] or '(none)'}")
    unexplained = [
        row["resource"] for row in hr_rows
        if row["kind"] == "queue" and row["capacity"] > 0
        and row["highwater"] >= row["capacity"]
        and not (weather_sim is not None
                 or (row["resource"] == "api_watch_queues"
                     and args.api_watch_queue_bound))]
    if unexplained:
        gate_failed("soak: UNEXPLAINED SATURATION — queue-kind resources hit "
              "their bound with no weather scenario or deliberately "
              f"tightened bound to blame: {unexplained}")
        ok = False
    # the prediction-before-overflow gate (armed by the tightened
    # bound): in the monitor's per-sample headroom trajectory, the
    # first sample ranking api_watch_queues first-to-break must
    # PRECEDE the first sample showing a drop — and both must exist,
    # or the drill was vacuous
    hr_t0 = monitor.samples[0]["t"] if monitor.samples else 0.0
    first_rank_t = first_drop_t = None
    for s in monitor.samples:
        h = s.get("subsystems", {}).get("headroom", {})
        if not h:
            continue
        if first_rank_t is None and \
                h.get("first_to_break") == "api_watch_queues":
            first_rank_t = round(s["t"] - hr_t0, 1)
        if first_drop_t is None and \
                h.get("api_watch_queues_drops", 0.0) > 0:
            first_drop_t = round(s["t"] - hr_t0, 1)
    if args.api_watch_queue_bound:
        if first_drop_t is None:
            gate_failed("soak: --api-watch-queue-bound set but the idle "
                  "watcher never overflowed (vacuous prediction drill "
                  "— bound too loose for this churn rate)")
            ok = False
        elif first_rank_t is None or first_rank_t >= first_drop_t:
            gate_failed("soak: the forecaster never ranked api_watch_queues "
                  "first-to-break BEFORE its first overflow (ranked_at="
                  f"{first_rank_t} first_drop={first_drop_t}) — the "
                  "observatory narrated the break instead of "
                  "predicting it")
            ok = False
        else:
            print(f"soak: headroom forecast led the first overflow by "
                  f"{first_drop_t - first_rank_t:.1f}s "
                  f"(ranked at t={first_rank_t}s, first drop at "
                  f"t={first_drop_t}s)")
    if args.headroom_out:
        import gzip as _gzip
        import json as _json
        hfields = ["t", "min_tte_seconds", "saturated", "episodes",
                   "probe_errors", "first_to_break",
                   "api_watch_queues_depth", "api_watch_queues_occ",
                   "api_watch_queues_drops"]
        head_series = [
            [round(s["t"] - hr_t0, 1)] + [
                h.get(k, 0.0) for k in hfields[1:]]
            for s in monitor.samples
            for h in [s.get("subsystems", {}).get("headroom", {})]
            if h]
        head_doc = {
            "final_table": hr_rows,
            "summary": hr_sum,
            "series_fields": hfields,
            "series": head_series,
            "watch_queue_bound": args.api_watch_queue_bound or None,
            "forecast_ranked_at_s": first_rank_t,
            "first_overflow_at_s": first_drop_t,
            "forecast_lead_s": (round(first_drop_t - first_rank_t, 1)
                                if first_rank_t is not None
                                and first_drop_t is not None else None),
            "unexplained_saturation": unexplained,
            "weather": (weather_sim.scenario.name
                        if weather_sim is not None else None),
            "soak": {"pods_churned": i, "minutes": args.minutes,
                     "seed": args.seed, "api_mode": bool(args.api_mode),
                     "watchers": args.watchers,
                     "churn_scale": args.churn_scale},
            "invariants_ok": ok,
        }
        if args.headroom_out.endswith(".gz"):
            with _gzip.open(args.headroom_out, "wt") as f:
                _json.dump(head_doc, f, separators=(",", ":"))
        else:
            with open(args.headroom_out, "w") as f:
                _json.dump(head_doc, f, indent=1)
        print(f"soak: headroom artifact -> {args.headroom_out} "
              f"({len(head_series)} trajectory samples)")
    if args.consol_out:
        # the CONSOLIDATION verdict (docs/reference/consolidation.md
        # "Gates"): the vmapped engine must demonstrably have carried
        # the run's consolidation — each bar names the machinery it
        # proves, so a quietly-dead engine can't ride a green soak
        eng = op.disruption.engine
        cst = eng.stats()
        cb = monitor.samples[0]["t"] if monitor.samples else 0.0
        consol_series = [
            [round(s["t"] - cb, 1)] + [
                s["subsystems"]["consolidation"].get(k, 0.0)
                for k in ("savings_per_hour", "nodes_consolidated",
                          "vmapped_whatifs", "batched_candidates",
                          "fp_unchanged", "host_fallbacks",
                          "weather_holds")]
            for s in monitor.samples
            if "consolidation" in s.get("subsystems", {})]
        print(f"soak: consolidation accepted={cst.get('accepted', 0):g} "
              f"nodes={cst.get('nodes_consolidated', 0):g} "
              f"savings/hr=${cst.get('savings_per_hour', 0.0):.4f} "
              f"dispatches={cst.get('vmapped_whatifs', 0):g} "
              f"({cst.get('batched_candidates', 0):g} sets) "
              f"cached={cst.get('fp_unchanged', 0):g} "
              f"host={cst.get('host_fallbacks', 0):g} "
              f"referee={cst.get('referee_checks', 0):g}/"
              f"{cst.get('referee_rejects', 0):g} rejects")
        if cst.get("accepted", 0) == 0:
            gate_failed("soak: --consol-out set but the engine never accepted "
                  "a removal (no savings recorded)")
            ok = False
        if cst.get("vmapped_whatifs", 0) == 0:
            gate_failed("soak: --consol-out set but no batched device "
                  "dispatch ever ran")
            ok = False
        elif cst.get("batched_candidates", 0) <= \
                cst.get("vmapped_whatifs", 0):
            gate_failed("soak: dispatches averaged <=1 candidate set — the "
                  "candidate axis never actually batched")
            ok = False
        if cst.get("fp_unchanged", 0) == 0:
            gate_failed("soak: the zero-leg probe cache never served a "
                  "fingerprint-unchanged candidate")
            ok = False
        if cst.get("referee_checks", 0) < cst.get("accepted", 0):
            gate_failed("soak: fewer referee checks than accepted removals — "
                  "an accept bypassed the host FFD envelope")
            ok = False
        import gzip as _gzip
        import json as _json
        consol_doc = {
            "engine": cst,
            "series_fields": ["t", "savings_per_hour",
                              "nodes_consolidated", "vmapped_whatifs",
                              "batched_candidates", "fp_unchanged",
                              "host_fallbacks", "weather_holds"],
            "series": consol_series,
            "slo": slo,
            "referee_envelope": 0.02,
            "weather": (weather_sim.scenario.name
                        if weather_sim is not None else None),
            "replay_identical": (bool(weather_doc["replay_match"])
                                 if weather_doc is not None else None),
            "soak": {"pods_churned": i, "minutes": args.minutes,
                     "seed": args.seed,
                     "consolidate_after": consolidate_after,
                     "churn_scale": args.churn_scale},
            "invariants_ok": ok,
        }
        if args.consol_out.endswith(".gz"):
            with _gzip.open(args.consol_out, "wt") as f:
                _json.dump(consol_doc, f, separators=(",", ":"))
        else:
            with open(args.consol_out, "w") as f:
                _json.dump(consol_doc, f, indent=1)
        print(f"soak: consolidation artifact -> {args.consol_out} "
              f"({len(consol_series)} trajectory samples)")
    if chaos_sidecars:
        pst = op.solver.pool_stats()
        print(f"soak: pool exit state endpoints={pst['endpoints']} "
              f"healthy={pst['healthy']} failovers={pst['failovers']} "
              f"delegated={pst['delegated_solves']} "
              f"local={pst['local_solves']}")
        op.solver.close()
        for sc_h in chaos_sidecars:
            sc_h.kill()
    import json as _json
    print("soak: failed gates " + _json.dumps(failed_gates))
    print("soak: INVARIANTS " + ("OK" if ok else "VIOLATED"))
    if not ok:
        print(dump_state(op))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
