"""Solver-pool failover: health-checked sidecar circuit breakers.

The single-sidecar shape (`sidecar.py RemoteSolver`,
``--solver-address``) is ONE address with ONE 60 s timeout and a
one-rung local fallback. That shape has two failure modes the paper's
<200 ms p50 bar cannot absorb: a *hung* sidecar (accepts the connection,
never answers) stalls a pass ~300x past the latency budget before the
flat timeout fires, and a dead sidecar turns every subsequent pass into
a connection-refused round trip plus a local solve. This module is the
fleet-shaped answer (health-checked sidecar discovery and
failover), mirroring the reference's operational posture —
controller restarts and dependency outages are routine, not exceptional:

- ``--solver-address`` grows to a comma-separated endpoint list
  (env ``SOLVER_ADDRESSES``); each endpoint is wrapped in a
  :class:`CircuitBreaker` (closed → open on consecutive failures or one
  deadline-class failure → half-open probation probe on the INJECTED
  clock, never wall time) with jittered exponential backoff;
- RPC deadlines split by purpose: the solve deadline derives from the
  SLO latency budget with a small multiplier
  (:data:`SOLVE_DEADLINE_MULTIPLIER`), the health deadline is ~1 s —
  previously both shared ``timeout=60.0``;
- a cheap periodic health check (:data:`HEALTH_INTERVAL_SECONDS`)
  catches silently-dead endpoints between solves, so a solve never has
  to be the thing that discovers an outage;
- failover routes among healthy endpoints — least-outstanding first,
  deterministic index tie-break — and the LOCAL solve is the final rung
  only when the whole pool is dark (``degraded_reason=pool-exhausted``,
  a declared taxonomy code);
- per-endpoint mesh/imbalance observation generalizes RemoteSolver's
  "report the sidecar that actually solved" contract: the operator's
  mesh gauges describe whichever endpoint carried the pass, and fall
  back to the local view the moment nothing delegates.

Surfaces: ``pool_stats()`` feeds the ``solver_pool`` introspection
provider (``kpctl top`` POOL row) and the ``karpenter_solver_pool_*``
gauges (docs/reference/solver-pool.md).

The endpoints speak this package's own unary gRPC (parallel/rpc.py). The
local Solver this pool subclasses, the final rung, runs on ``device``
(None = ``cuda``): the Operator passes its own.
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional, Sequence, Tuple

from .. import trace
from ..device import DeviceLike
from ..solver.solve import NodePlan, Solver
from ..solver.taxonomy import POOL_EXHAUSTED, SIDECAR_HUNG
from ..utils.clock import WALL
from ..utils.logging import get_logger

# the solve deadline, derived from the SLO latency budget: generous
# enough for a sidecar-side cold compile of a new bucket shape, still
# ~6x tighter than the old flat 60 s (a hung endpoint costs at most one
# deadline before its breaker opens and the pass fails over)
SOLVE_DEADLINE_MULTIPLIER = 50.0
# health probes answer from the resident lattice without touching the
# device — a hung process should cost a probe ~1 s, not a minute
HEALTH_DEADLINE_SECONDS = 1.0
# cadence of the cheap closed-endpoint health check (injected clock)
HEALTH_INTERVAL_SECONDS = 5.0
# breaker tuning: consecutive cheap failures before opening, the base
# probation window, and its exponential-backoff ceiling
BREAKER_FAILURE_THRESHOLD = 3
BREAKER_OPEN_SECONDS = 2.0
BREAKER_MAX_OPEN_SECONDS = 30.0

# numeric breaker-state encoding for gauges / sampler rings / kpctl
STATE_NUM = {"closed": 0, "half-open": 1, "open": 2}


def parse_addresses(spec) -> Tuple[str, ...]:
    """``"unix:/a.sock, host:50051"`` → ``("unix:/a.sock", "host:50051")``.
    Accepts a comma-separated string or any sequence of addresses."""
    if isinstance(spec, str):
        parts = [a.strip() for a in spec.split(",")]
    else:
        parts = [str(a).strip() for a in spec]
    out = tuple(a for a in parts if a)
    if not out:
        raise ValueError(f"solver pool: no endpoint in {spec!r}")
    return out


class CircuitBreaker:
    """Per-endpoint breaker on the INJECTED clock.

    closed → (consecutive failures ≥ threshold, or one deadline-class
    failure) → open → [probation elapses] → half-open (exactly one probe
    rides through) → closed on success / re-open with doubled, jittered
    probation on failure. Probation jitter draws from a per-endpoint
    seeded RNG so N breakers opened by one outage don't probe in
    lockstep — and two runs with the same endpoints behave identically.
    """

    def __init__(self, clock, name: str = "",
                 failure_threshold: int = BREAKER_FAILURE_THRESHOLD,
                 open_seconds: float = BREAKER_OPEN_SECONDS,
                 max_open_seconds: float = BREAKER_MAX_OPEN_SECONDS):
        self._clock = clock
        self.failure_threshold = int(failure_threshold)
        self.open_seconds = float(open_seconds)
        self.max_open_seconds = float(max_open_seconds)
        self.state = "closed"
        self.consecutive_failures = 0
        self.opens = 0              # lifetime opens (monotonic evidence)
        self._open_streak = 0       # consecutive opens (backoff exponent)
        self._probe_at = 0.0
        self._rng = random.Random(f"breaker:{name}")

    def record_success(self) -> None:
        self.state = "closed"
        self.consecutive_failures = 0
        self._open_streak = 0

    def record_failure(self, fatal: bool = False) -> None:
        """``fatal`` marks a deadline-class failure (a hung endpoint):
        one costs a full solve deadline, so the breaker opens
        immediately instead of paying the threshold out ``N`` times."""
        self.consecutive_failures += 1
        if (fatal or self.state == "half-open"
                or self.consecutive_failures >= self.failure_threshold):
            self._open()

    def _open(self) -> None:
        self.state = "open"
        self.opens += 1
        self._open_streak += 1
        base = min(self.open_seconds * (2.0 ** (self._open_streak - 1)),
                   self.max_open_seconds)
        # jitter in [0.5, 1.5): deterministic per endpoint, de-phased
        # across endpoints
        self._probe_at = (self._clock.monotonic()
                          + base * (0.5 + self._rng.random()))

    def probe_due(self) -> bool:
        return (self.state == "open"
                and self._clock.monotonic() >= self._probe_at)

    def begin_probe(self) -> None:
        """Open → half-open: exactly one probe may ride through; its
        outcome decides close vs re-open (record_success/record_failure)."""
        self.state = "half-open"


class PoolEndpoint:
    """One sidecar endpoint: client + breaker + routing/observation
    state. The client is built lazily so constructing a pool (and
    validating options) never opens channels."""

    def __init__(self, index: int, address: str, clock,
                 solve_deadline: float, health_deadline: float):
        self.index = index
        self.address = address
        self.breaker = CircuitBreaker(clock, name=address)
        self.solve_deadline = solve_deadline
        self.health_deadline = health_deadline
        self.outstanding = 0        # in-flight solve RPCs (routing key)
        self.solves = 0             # delegated solves this endpoint won
        self.failures = 0           # lifetime failed attempts/probes
        self.last_health = -1e18    # injected-clock stamp of last check
        self.last_error = ""
        # RemoteSolver's observation contract, per endpoint: mesh shape and
        # imbalance of the plans THIS endpoint returned
        self.mesh_devices = 0
        self.shard_imbalance = 0.0
        self.sharded_solves = 0
        self._client = None

    def client(self):
        if self._client is None:
            from .sidecar import SolverClient
            self._client = SolverClient(
                self.address, timeout=self.solve_deadline,
                health_timeout=self.health_deadline)
        return self._client

    def observe_plan(self, plan: NodePlan) -> None:
        self.mesh_devices = plan.mesh_devices
        self.shard_imbalance = plan.shard_imbalance
        if plan.mesh_devices > 1:
            self.sharded_solves += 1

    def close(self) -> None:
        if self._client is not None:
            self._client.close()
            self._client = None


class SolverPool(Solver):
    """A Solver whose provisioning solves run on a POOL of sidecar
    processes, failing over between them and degrading to the local
    in-process solve only when every endpoint is dark.

    Subclasses Solver exactly like RemoteSolver: probe_batch (the
    disruption controller's vmapped what-ifs), lattice queries, and
    warmup stay local, and the local solver IS the final ladder rung."""

    # provisioning solves belong to the pool; the in-process delta fast
    # path would silently bypass delegation (same contract as
    # RemoteSolver)
    supports_delta = False

    def __init__(self, lattice, addresses, clock=None,
                 solve_deadline: Optional[float] = None,
                 health_deadline: float = HEALTH_DEADLINE_SECONDS,
                 health_interval: float = HEALTH_INTERVAL_SECONDS,
                 latency_budget_seconds: float = 0.2,
                 pipeline: bool = True, mesh=None, device: DeviceLike = None):
        super().__init__(lattice, device=device, pipeline=pipeline,
                         clock=clock, mesh=mesh)
        self.log = get_logger("solver_pool")
        if solve_deadline is None or solve_deadline <= 0:
            solve_deadline = derive_solve_deadline(latency_budget_seconds)
        self.solve_deadline = float(solve_deadline)
        self.health_deadline = float(health_deadline)
        self.health_interval = float(health_interval)
        # breakers/health ride the INJECTED clock (FakeClock tests step
        # probation deterministically); RPC deadlines are wall-time by
        # nature and use the deadline values directly
        self._pool_clock = clock if clock is not None else WALL
        self.endpoints: List[PoolEndpoint] = [
            PoolEndpoint(i, a, self._pool_clock,
                         self.solve_deadline, self.health_deadline)
            for i, a in enumerate(parse_addresses(addresses))]
        # bookkeeping guarded by the instrumented pool lock (counter
        # mutations only — RPCs NEVER run under it)
        from ..introspect.contention import lock as _ilock
        self._plock = _ilock("solver_pool")
        self.failovers = 0          # failed endpoint attempts that fell
        #                             through to another endpoint / local
        self.delegated_solves = 0
        self.local_solves = 0
        self.health_checks = 0
        self.probes = 0
        self._last_ep: Optional[int] = None   # endpoint that last solved

    # ---- health / probation ---------------------------------------------

    def _health_ok(self, ep: PoolEndpoint) -> bool:
        try:
            doc = ep.client().health()
            return bool(doc.get("ok"))
        except Exception as e:   # RpcError, protocol junk — all unhealthy
            ep.last_error = f"{type(e).__name__}: {e}"
            return False

    def check_endpoints(self) -> None:
        """The cheap periodic pass: half-open probes for due breakers,
        interval health checks for closed endpoints. Runs at every solve
        entry (and callable directly — soaks/smokes poll it while no
        solve is in flight, so recovery is observed between passes)."""
        now = self._pool_clock.monotonic()
        for ep in self.endpoints:
            br = ep.breaker
            if br.probe_due():
                with self._plock:
                    self.probes += 1
                br.begin_probe()
                ok = self._health_ok(ep)
                ep.last_health = now
                if ok:
                    br.record_success()
                    self.log.info("solver pool endpoint recovered",
                                  endpoint=ep.address)
                else:
                    with self._plock:
                        ep.failures += 1
                    br.record_failure()
            elif (br.state == "closed"
                  and now - ep.last_health >= self.health_interval):
                with self._plock:
                    self.health_checks += 1
                ep.last_health = now
                if not self._health_ok(ep):
                    with self._plock:
                        ep.failures += 1
                    br.record_failure()
                # NB a liveness success is deliberately NOT a breaker
                # success: a flapping sidecar whose health answers but
                # whose solves keep failing must still open after the
                # threshold — only a real successful RPC resets the
                # streak (record_success at the solve site)

    # ---- routing ---------------------------------------------------------

    def _routable(self) -> List[PoolEndpoint]:
        """Healthy endpoints, least-outstanding first; index breaks
        ties deterministically."""
        eps = [ep for ep in self.endpoints if ep.breaker.state == "closed"]
        return sorted(eps, key=lambda e: (e.outstanding, e.index))

    def solve_relaxed(self, pods, node_pools, lattice=None, existing=(),
                      daemonset_pods=(), bound_pods=(), pvcs=None,
                      storage_classes=None, mesh=None,
                      pool_headroom=None, problem0=None) -> NodePlan:
        from . import rpc
        from .sidecar import SidecarProtocolError, classify_sidecar_failure
        self.check_endpoints()
        attempts: List[str] = []     # "addr: reason" per failed attempt
        for ep in self._routable():
            with self._plock:
                ep.outstanding += 1
            # the attempt span keeps the cross-process trace contract:
            # the winning endpoint's sidecar spans ingest under it, a
            # failed attempt stays in the tree marked status=error
            sp = trace.span("solver.remote", pods=len(pods),
                            address=ep.address, endpoint=ep.index,
                            attempt=len(attempts))
            try:
                with sp:
                    plan = ep.client().solve(
                        pods, node_pools, existing=existing,
                        daemonset_pods=daemonset_pods,
                        bound_pods=bound_pods, pvcs=pvcs,
                        storage_classes=storage_classes,
                        pool_headroom=pool_headroom,
                        unavailable=self._unavailable_entries(lattice))
                    sp.set(path=plan.solver_path, degraded=plan.degraded,
                           reason=plan.degraded_reason)
            except (rpc.RpcError, SidecarProtocolError) as e:
                reason = classify_sidecar_failure(e)
                # the span already closed status=error (the exception
                # crossed its __exit__); pin the bounded reason on it
                sp.set(reason=reason)
                detail = (f"{type(e).__name__}: {e.code()}"
                          if isinstance(e, rpc.RpcError)
                          and hasattr(e, "code") else str(e))
                with self._plock:
                    ep.failures += 1
                    self.failovers += 1
                ep.last_error = detail
                ep.breaker.record_failure(fatal=reason == SIDECAR_HUNG)
                attempts.append(f"{ep.address}: {reason}")
                self.log.warning("solver pool endpoint failed, failing over",
                                 endpoint=ep.address, reason=reason,
                                 error=detail)
                continue
            finally:
                # ALL exits, including an unexpected exception escaping
                # the attempt: a leaked +1 would permanently demote this
                # endpoint in least-outstanding routing
                with self._plock:
                    ep.outstanding -= 1
            with self._plock:
                ep.solves += 1
                self.delegated_solves += 1
                self._last_ep = ep.index
            ep.breaker.record_success()
            ep.observe_plan(plan)
            if attempts:
                # the pass survived on a healthy endpoint; record the
                # attempts it burned (human detail — the plan itself is
                # NOT degraded, the pool did exactly its job)
                plan.warnings.extend(
                    f"solver pool failover: {a}" for a in attempts)
            return plan
        # the whole pool is dark: the LOCAL solver is the final rung —
        # provenance marks the plan so the flight recorder tail-retains
        # the trace and the degraded counter/gauge surfaces say WHY
        with self._plock:
            self.local_solves += 1
            self._last_ep = None
        self._count_degraded(POOL_EXHAUSTED)
        with trace.span("solver.local_fallback",
                        reason=POOL_EXHAUSTED, pods=len(pods)) as sp:
            sp.set(attempts=len(attempts))
            plan = super().solve_relaxed(
                pods, node_pools, lattice=lattice, existing=existing,
                daemonset_pods=daemonset_pods, bound_pods=bound_pods,
                pvcs=pvcs, storage_classes=storage_classes, mesh=mesh,
                pool_headroom=pool_headroom, problem0=problem0)
        plan.degraded = True
        plan.degraded_reason = plan.degraded_reason or POOL_EXHAUSTED
        plan.warnings.extend(
            f"solver pool failover: {a}" for a in attempts)
        return plan

    # _unavailable_entries is shared with RemoteSolver (the ICE triples
    # that cross the wire); import here to avoid a copy drifting
    def _unavailable_entries(self, view):
        from .sidecar import RemoteSolver
        return RemoteSolver._unavailable_entries(self, view)

    # ---- observation / introspection ------------------------------------

    def stats(self) -> Dict[str, object]:
        out = super().stats()
        # cumulative sharded evidence: local solves + every sharded plan
        # any endpoint returned (never goes backwards)
        out["mesh_solves"] = (out.get("mesh_solves", 0)
                              + sum(ep.sharded_solves
                                    for ep in self.endpoints))
        last = self._last_ep
        if last is not None and self.endpoints[last].mesh_devices:
            # the gauges describe the endpoint that actually solved; a
            # dark pool reports the local view (super()'s) instead of
            # advertising a mesh nothing solves on
            ep = self.endpoints[last]
            out["mesh_devices"] = ep.mesh_devices
            out["mesh_shard_imbalance"] = round(ep.shard_imbalance, 4)
        return out

    def pool_stats(self) -> Dict[str, object]:
        """The ``solver_pool`` introspection provider (kpctl top POOL
        row; karpenter_solver_pool_* gauges). Counter reads only — no
        RPC, no lock wait on an in-flight solve."""
        out: Dict[str, object] = {
            "endpoints": len(self.endpoints),
            "healthy": sum(1 for ep in self.endpoints
                           if ep.breaker.state == "closed"),
            "failovers": self.failovers,
            "delegated_solves": self.delegated_solves,
            "local_solves": self.local_solves,
            "health_checks": self.health_checks,
            "probes": self.probes,
            "solve_deadline_s": self.solve_deadline,
            "health_deadline_s": self.health_deadline,
        }
        # the total rides the SAME read the headroom registry probes —
        # one source of truth, never a second hand-summed code path
        out["outstanding_total"] = self.headroom_probe()["depth"]
        for ep in self.endpoints:
            pre = f"ep{ep.index}"
            out[f"{pre}_address"] = ep.address
            out[f"{pre}_state"] = STATE_NUM[ep.breaker.state]
            out[f"{pre}_outstanding"] = ep.outstanding
            out[f"{pre}_solves"] = ep.solves
            out[f"{pre}_failures"] = ep.failures
            out[f"{pre}_breaker_opens"] = ep.breaker.opens
            out[f"{pre}_mesh_devices"] = ep.mesh_devices
        return out

    def headroom_probe(self) -> Dict[str, float]:
        """In-flight solve RPCs across the pool (introspect/headroom.py).
        Unbounded in code — the forecast watches the fill rate: a rate
        that outruns the sidecars' drain is the elastic-fleet scale-up
        signal. drops = failovers (attempts that fell through)."""
        return {"depth": float(sum(ep.outstanding
                                   for ep in self.endpoints)),
                "capacity": 0.0,
                "drops": float(self.failovers)}

    def breaker_states(self) -> Dict[str, str]:
        """address → breaker state (the per-endpoint gauge labels)."""
        return {ep.address: ep.breaker.state for ep in self.endpoints}

    def close(self) -> None:
        for ep in self.endpoints:
            ep.close()


def derive_solve_deadline(latency_budget_seconds: float) -> float:
    """The solve RPC deadline from the SLO latency budget (0.2 s budget
    → 10 s): small multiplier, documented in one place."""
    return float(latency_budget_seconds) * SOLVE_DEADLINE_MULTIPLIER
