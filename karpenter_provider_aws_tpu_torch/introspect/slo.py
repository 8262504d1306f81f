"""SLO burn tracking: the paper's contract, watched at runtime.

The paper's contract is an SLO — 50k pods x 700+ instance types solved
in <200 ms p50 at <=2% cost regression vs the FFD referee — and until
now nothing in the process MEASURED it continuously: benches prove it
offline, traces explain one slow pass after the fact. This tracker
keeps rolling windows of both bars:

- **latency**: every provisioning pass records its end-to-end solve
  latency (``NodePlan.solve_seconds`` — tensorize + device solve +
  decode); the tracker maintains windowed p50/p99 and reports
  ``latency burn = p50 / 200 ms``.
- **cost**: on a sampled cadence (default every 60 s of passes that
  actually opened nodes — the FFD referee is host work and must never
  ride every pass) the provisioner re-packs the SAME problem with the
  host FFD oracle and records ``plan cost / referee cost``; the tracker
  reports ``cost burn = (windowed p50 ratio - 1) / 2%``.

``update()`` (driven from Operator.emit_gauges — every deterministic
pass, the 5 s metrics controller in the async runtime) exports both
burns as ``karpenter_slo_latency_budget_burn`` /
``karpenter_slo_cost_budget_burn`` gauges and publishes ONE
``SloBudgetBurn`` warning event per sustained episode (burn > 1.0 for
``sustain_seconds``), re-arming when the burn recovers.

Burn > 1.0 means the window is violating the paper's bar; a dashboard
alert on either gauge is the runtime restatement of the acceptance
criteria every perf PR is judged against.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Callable, Deque, Dict, Optional, Tuple

LATENCY_BUDGET_SECONDS = 0.200   # PAPER.md: <200 ms p50 end-to-end
COST_BUDGET_RATIO = 0.02         # PAPER.md: <=2% regression vs FFD referee
WINDOW_SECONDS = 300.0
SUSTAIN_SECONDS = 30.0
REFEREE_INTERVAL_SECONDS = 60.0
MAX_SAMPLES = 4096               # per window ring; bounds memory forever


def _percentile(values, q: float) -> float:
    if not values:
        return 0.0
    s = sorted(values)
    idx = min(int(q * len(s)), len(s) - 1)
    return float(s[idx])


class SloTracker:
    def __init__(self, clock, recorder=None, metrics=None,
                 latency_budget_seconds: float = LATENCY_BUDGET_SECONDS,
                 cost_budget_ratio: float = COST_BUDGET_RATIO,
                 window_seconds: float = WINDOW_SECONDS,
                 sustain_seconds: float = SUSTAIN_SECONDS,
                 referee_interval: float = REFEREE_INTERVAL_SECONDS):
        self._clock = clock
        self._recorder = recorder
        self.latency_budget_seconds = latency_budget_seconds
        self.cost_budget_ratio = cost_budget_ratio
        self.window_seconds = window_seconds
        self.sustain_seconds = sustain_seconds
        self.referee_interval = referee_interval
        self._lat: Deque[Tuple[float, float]] = deque(maxlen=MAX_SAMPLES)
        self._cost: Deque[Tuple[float, float]] = deque(maxlen=MAX_SAMPLES)
        self._lock = threading.Lock()
        self._gauges = None
        if metrics is not None:
            self._gauges = (
                metrics.gauge("karpenter_slo_latency_budget_burn"),
                metrics.gauge("karpenter_slo_cost_budget_burn"))
        # per-burn-kind episode state: when the burn FIRST exceeded 1.0
        # (None = within budget) and whether this episode already fired
        self._over_since: Dict[str, Optional[float]] = {"latency": None,
                                                        "cost": None}
        self._fired: Dict[str, bool] = {"latency": False, "cost": False}
        self._last_referee = float("-inf")
        self.referee_runs = 0
        self.referee_errors = 0
        # explicit boot warmup window: while open, latency samples are
        # DROPPED — a cold-compile first pass is boot cost, not steady-
        # state SLO signal, and must not fire a SloBudgetBurn episode
        # (SOAK_r06 recorded peak burn ~8 from exactly this). Opened by
        # the operator when AOT warmup starts, closed by the warmup
        # thread's on_done (with max_seconds as the crash backstop).
        self._warmup_until = float("-inf")
        self.warmup_dropped = 0
        # observers of the sustained-burn edge. ``on_sustained(kind,
        # burn, detail)`` fires EXACTLY where the SloBudgetBurn event
        # does — once per episode, re-armed on recovery — so a
        # burn-triggered profile capture (introspect/profiler.py
        # BurnCapture) inherits the episode semantics for free.
        # ``_capture`` additionally sees every recorded pass latency
        # (its own slow-pass trigger).
        self.on_sustained: Optional[Callable[[str, float, str], None]] = None
        self._capture = None

    def attach_capture(self, capture) -> None:
        """Wire a BurnCapture: sustained episodes AND grossly
        over-budget single passes snapshot profile+contention evidence
        (docs/reference/profiling.md)."""
        self._capture = capture
        if capture is not None:
            self.on_sustained = capture.on_sustained_burn

    def headroom_probe(self) -> Dict[str, float]:
        """Sample-window ring occupancy (introspect/headroom.py): the
        fuller of the latency/cost rings. ``kind="ring"`` — the windows
        are bounded by design; old samples aging out IS the window."""
        with self._lock:
            depth = max(len(self._lat), len(self._cost))
        return {"depth": float(depth), "capacity": float(MAX_SAMPLES),
                "kind": "ring"}

    # ---- boot warmup window ----------------------------------------------

    def begin_warmup(self, max_seconds: float = 600.0) -> None:
        """Open the warmup window: latency recorded before end_warmup()
        (or ``max_seconds`` from now, whichever first) is boot compile
        cost and stays out of the burn windows."""
        with self._lock:
            self._warmup_until = self._clock.now() + max_seconds

    def end_warmup(self) -> None:
        """Close the warmup window (idempotent; safe from the warmup
        thread)."""
        with self._lock:
            self._warmup_until = min(self._warmup_until, self._clock.now())

    def warmup_active(self) -> bool:
        return self._clock.now() < self._warmup_until

    # ---- recording (hot path: O(1) appends) -------------------------------

    def record_latency(self, seconds: float) -> None:
        with self._lock:
            now = self._clock.now()
            if now < self._warmup_until:
                # boot warmup: cold-compile passes are not SLO signal
                self.warmup_dropped += 1
                return
            self._lat.append((now, float(seconds)))
        cap = self._capture
        if cap is not None:
            # outside the lock: a capture walks profiler/contention
            # state and must never serialize the recording hot path
            try:
                cap.note_latency(float(seconds))
            except Exception:
                pass   # evidence collection must not fail provisioning

    def record_cost_ratio(self, ratio: float) -> None:
        with self._lock:
            self._cost.append((self._clock.now(), float(ratio)))

    def maybe_cost_referee(self, plan, problem_builder: Callable[[], object]
                           ) -> Optional[float]:
        """Sampled FFD-referee comparison: at most one host re-pack per
        ``referee_interval``, only for passes that opened new nodes (an
        all-existing pass has no cost to regress). Never raises — a
        referee bug must not take down provisioning."""
        if not plan.new_nodes or plan.new_node_cost <= 0:
            return None
        now = self._clock.now()
        with self._lock:
            if now - self._last_referee < self.referee_interval:
                return None
            self._last_referee = now
        try:
            from ..solver.oracle import ffd_oracle
            oracle = ffd_oracle(problem_builder())
            if oracle.new_node_cost <= 0:
                return None
            ratio = float(plan.new_node_cost) / float(oracle.new_node_cost)
        except Exception:
            with self._lock:
                self.referee_errors += 1
            return None
        with self._lock:
            self.referee_runs += 1
        self.record_cost_ratio(ratio)
        return ratio

    # ---- windowed reads ---------------------------------------------------

    def _window(self, ring: Deque[Tuple[float, float]]) -> list:
        cutoff = self._clock.now() - self.window_seconds
        with self._lock:
            # prune in place (left side is oldest), then copy values
            while ring and ring[0][0] < cutoff:
                ring.popleft()
            return [v for _, v in ring]

    def latency_percentiles(self) -> Tuple[float, float]:
        vals = self._window(self._lat)
        return _percentile(vals, 0.50), _percentile(vals, 0.99)

    def cost_ratio_p50(self) -> float:
        return _percentile(self._window(self._cost), 0.50)

    # ---- the burn decision ------------------------------------------------

    def update(self) -> Dict[str, float]:
        """Recompute both burns, export the gauges, and fire/re-arm the
        sustained-burn event. Cheap enough for every reconcile pass."""
        p50, p99 = self.latency_percentiles()
        latency_burn = p50 / self.latency_budget_seconds
        ratio = self.cost_ratio_p50()
        cost_burn = (max(ratio - 1.0, 0.0) / self.cost_budget_ratio
                     if ratio > 0 else 0.0)
        if self._gauges is not None:
            self._gauges[0].set(round(latency_burn, 4))
            self._gauges[1].set(round(cost_burn, 4))
        self._check_sustained("latency", latency_burn,
                              f"p50 {p50 * 1000:.1f} ms over the "
                              f"{self.latency_budget_seconds * 1000:.0f} ms "
                              "budget")
        self._check_sustained("cost", cost_burn,
                              f"cost ratio {ratio:.4f} over the "
                              f"{1 + self.cost_budget_ratio:.2f}x FFD-referee "
                              "budget")
        return {"latency_burn": round(latency_burn, 4),
                "cost_burn": round(cost_burn, 4),
                "latency_p50_ms": round(p50 * 1000, 3),
                "latency_p99_ms": round(p99 * 1000, 3),
                "cost_ratio_p50": round(ratio, 4)}

    def _check_sustained(self, kind: str, burn: float, detail: str) -> None:
        # episode state mutates under the lock: update() runs from both
        # the metrics controller and the sampler thread, and an episode
        # must fire its event exactly once
        now = self._clock.now()
        fire = False
        with self._lock:
            if burn <= 1.0:
                self._over_since[kind] = None
                self._fired[kind] = False   # episode over: re-arm
                return
            if self._over_since[kind] is None:
                self._over_since[kind] = now
            if (not self._fired[kind]
                    and now - self._over_since[kind] >= self.sustain_seconds):
                self._fired[kind] = True
                fire = True
        if fire:
            if self._recorder is not None:
                self._recorder.publish(
                    "Warning", "SloBudgetBurn", "Provisioner", "default",
                    f"{kind} budget burn {burn:.2f} sustained "
                    f">{self.sustain_seconds:.0f}s ({detail})")
            cb = self.on_sustained
            if cb is not None:
                try:
                    cb(kind, burn, detail)
                except Exception:
                    pass   # a capture bug must not break burn tracking

    # ---- introspection provider -------------------------------------------

    def stats(self) -> Dict:
        burns = self.update()
        with self._lock:
            burns.update({
                "latency_samples": len(self._lat),
                "cost_samples": len(self._cost),
                "referee_runs": self.referee_runs,
                "referee_errors": self.referee_errors,
                "latency_budget_ms": self.latency_budget_seconds * 1000.0,
                "cost_budget_pct": self.cost_budget_ratio * 100.0,
                "warmup_active": (1.0 if self._clock.now()
                                  < self._warmup_until else 0.0),
                "warmup_dropped": self.warmup_dropped,
            })
        return burns
