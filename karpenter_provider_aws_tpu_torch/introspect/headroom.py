"""Saturation observatory: the process-wide headroom registry.

ROADMAP item 4 ends with "whatever profiling shows breaking first at
that scale is the next refactor target" — this module turns that
question into an instrument. Every bounded resource in the process
(watch queues, publish queues, journal windows, audit/sampler rings,
batcher buckets, caches) registers a CHEAP probe, and the registry
derives, on the injected clock:

- windowed EWMA **fill/drain rates** from successive depth readings
  (dropped items count as fill pressure — an overflowing queue whose
  depth is pinned at the bound is still filling),
- a **headroom burn rate** (occupancy / high-water fraction — the
  occupancy analog of the SLO burn: > 1.0 means the resource is past
  the fraction a saturating process crosses before it breaks),
- a per-resource **time-to-exhaustion forecast**
  ``(capacity - depth) / net fill rate``, ranked into a first-to-break
  table — so a scaled-up soak names its next refactor target while the
  run is still green, not after the 410/overflow already fired.

Probe contract (see docs/reference/headroom.md): a zero-argument
callable returning a dict of cheap counter reads —

    {"depth": float,            # current occupancy (required)
     "capacity": float,         # bound; 0 = unbounded (forecast only)
     "highwater": float,        # optional structure-kept high water
     "drops": float,            # optional cumulative overflow/drop count
     "kind": "queue" | "ring"}  # ring = full-by-design (see below)

``kind="ring"`` marks circular telemetry buffers (sampler rings, the
decision-audit ring, event history) whose *job* is to sit at capacity:
they stay in the registry and the gauge families, but they never rank
in the first-to-break table, never fire the high-water capture, and
never fail the soak's no-unexplained-saturation verdict — wrapping is
retention policy, not data loss. ``kind="queue"`` (the default) is a
backlog whose saturation means drops/410s/stalls.

High water is MONOTONIC PER PROCESS: the registry folds every observed
depth (and any structure-kept high water) into a max that never resets,
even when the probe's own readout regresses (e.g. a dropped watcher
taking its queue with it).

Crossing the configurable high-water fraction (default 0.9) of a
queue-kind resource triggers the existing burn-capture machinery
(introspect/profiler.py BurnCapture) EXACTLY ONCE PER EPISODE — armed
again only after occupancy recovers below the fraction — so the
flamegraph of the saturating moment is retained at
``/debug/pprof/captures`` with reason ``headroom-<resource>``.

Probes are registered by ``Operator._wire_headroom`` and error-isolated
exactly like introspection providers: one broken probe marks its own
row with ``error`` and can never poison the ranked table.
"""

from __future__ import annotations

import math
import threading
from typing import Callable, Dict, List, Optional

DEFAULT_HIGH_WATER_FRACTION = 0.9
# EWMA time constant for the fill/drain rates: ~30 s of history, the
# same order as the SLO tracker's sustain window — long enough that one
# bursty pass does not name a false first-to-break, short enough that a
# soak's ramp shows up before the overflow does
EWMA_TAU_SECONDS = 30.0
# net fill below this (items/second) reads as "not filling": forecast
# noise floor, so a flat queue never reports a billion-second TTE
MIN_NET_FILL = 1e-9

Probe = Callable[[], Dict]


class _Resource:
    """Per-resource observation state (mutated only under the registry
    lock; the probe itself is called outside it)."""

    __slots__ = ("name", "probe", "kind", "depth", "capacity", "highwater",
                 "drops", "fill_rate", "drain_rate", "last_t", "last_depth",
                 "last_drops", "error", "fired", "episodes", "observations")

    def __init__(self, name: str, probe: Probe):
        self.name = name
        self.probe = probe
        self.kind = "queue"
        self.depth = 0.0
        self.capacity = 0.0
        self.highwater = 0.0       # monotonic per process, never resets
        self.drops = 0.0
        self.fill_rate = 0.0       # EWMA items/s of inflow pressure
        self.drain_rate = 0.0      # EWMA items/s of outflow
        self.last_t: Optional[float] = None
        self.last_depth = 0.0
        self.last_drops = 0.0
        self.error: Optional[str] = None
        self.fired = False         # high-water episode armed/fired state
        self.episodes = 0
        self.observations = 0


class HeadroomRegistry:
    """Process-wide registry of bounded-resource probes + the forecast.

    ``register_probe`` is replace-by-name like the introspection
    registry (a rebuilt Operator swaps its probes instead of leaking
    them); ``observe()`` takes one reading of every probe on the
    injected clock; ``table()`` returns the ranked first-to-break view;
    ``stats()`` is the ``headroom`` introspection provider; ``doc()``
    serves ``/debug/headroom`` on both HTTP servers."""

    def __init__(self, clock,
                 high_water_fraction: float = DEFAULT_HIGH_WATER_FRACTION,
                 tau_seconds: float = EWMA_TAU_SECONDS):
        self._clock = clock
        self.high_water_fraction = float(high_water_fraction)
        self.tau_seconds = float(tau_seconds)
        self._lock = threading.Lock()
        self._resources: Dict[str, _Resource] = {}
        self._capture = None
        self.probe_errors = 0

    # ---- registration ------------------------------------------------------

    def register_probe(self, name: str, probe: Probe) -> None:
        with self._lock:
            self._resources[name] = _Resource(name, probe)

    def unregister_probe(self, name: str) -> None:
        with self._lock:
            self._resources.pop(name, None)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._resources)

    def attach_capture(self, capture) -> None:
        """Wire the burn-capture machinery: a queue-kind resource
        crossing the high-water fraction snapshots profile + contention
        evidence once per episode (docs/reference/profiling.md)."""
        self._capture = capture

    # ---- observation -------------------------------------------------------

    def observe(self) -> None:
        """One reading of every probe. Cheap (counter reads), never
        raises: a broken probe marks its own row and the rest of the
        sweep proceeds. Called from Operator.emit_gauges (every pass /
        the 5 s metrics controller) and from stats()."""
        with self._lock:
            targets = list(self._resources.values())
        now = float(self._clock.now())
        fire: List[Dict] = []
        for r in targets:
            try:
                reading = r.probe()
                depth = float(reading["depth"])
            except Exception as e:   # noqa: BLE001 — probe isolation
                with self._lock:
                    if r.error is None:
                        self.probe_errors += 1
                    r.error = f"{type(e).__name__}: {e}"
                continue
            capacity = float(reading.get("capacity", 0.0) or 0.0)
            drops = float(reading.get("drops", 0.0) or 0.0)
            kind = str(reading.get("kind", "queue"))
            probe_hw = float(reading.get("highwater", 0.0) or 0.0)
            with self._lock:
                r.error = None
                r.kind = kind
                r.capacity = capacity
                # monotonic high water: fold the probe's own readout in,
                # never let either side reset it
                r.highwater = max(r.highwater, r.depth, depth, probe_hw)
                if r.last_t is not None:
                    dt = now - r.last_t
                    if dt > 0.0:
                        net = (depth - r.last_depth) / dt
                        drop_rate = max(drops - r.last_drops, 0.0) / dt
                        # dropped items were inflow that never raised
                        # depth: an overflowing queue pinned at its
                        # bound is still FILLING at the drop rate
                        fill = max(net, 0.0) + drop_rate
                        drain = max(-net, 0.0)
                        alpha = 1.0 - math.exp(-dt / self.tau_seconds)
                        r.fill_rate += alpha * (fill - r.fill_rate)
                        r.drain_rate += alpha * (drain - r.drain_rate)
                r.depth = depth
                r.drops = drops
                r.last_t = now
                r.last_depth = depth
                r.last_drops = drops
                r.observations += 1
                # the high-water episode edge (the SloTracker
                # _check_sustained shape): fire once when a queue-kind
                # resource crosses the fraction, re-arm on recovery
                if capacity > 0.0 and kind == "queue":
                    occ = depth / capacity
                    if occ >= self.high_water_fraction:
                        if not r.fired:
                            r.fired = True
                            r.episodes += 1
                            fire.append(self._row_locked(r))
                    else:
                        r.fired = False
        cap = self._capture
        if cap is not None:
            for row in fire:
                try:
                    # outside the lock: a capture walks profiler +
                    # contention state and must never serialize observe()
                    cap.capture(f"headroom-{row['resource']}",
                                resource=row["resource"],
                                occupancy=row["occupancy"],
                                depth=row["depth"],
                                capacity=row["capacity"],
                                fill_rate=row["fill_rate"],
                                seconds_to_exhaustion=row[
                                    "seconds_to_exhaustion"])
                except Exception:
                    pass   # evidence collection must not fail the sweep

    # ---- the forecast ------------------------------------------------------

    def _forecast_locked(self, r: _Resource) -> Optional[float]:
        """Seconds until ``depth`` reaches ``capacity`` at the current
        EWMA net fill. None = no exhaustion in sight: unbounded, a ring
        (full-by-design), or draining at least as fast as it fills."""
        if r.capacity <= 0.0 or r.kind != "queue":
            return None
        net = r.fill_rate - r.drain_rate
        if net <= MIN_NET_FILL:
            return None
        return max(r.capacity - r.depth, 0.0) / net

    def _row_locked(self, r: _Resource) -> Dict:
        tte = self._forecast_locked(r)
        occ = (r.depth / r.capacity) if r.capacity > 0.0 else 0.0
        burn = (occ / self.high_water_fraction
                if r.capacity > 0.0 and r.kind == "queue" else 0.0)
        return {
            "resource": r.name,
            "kind": r.kind,
            "depth": round(r.depth, 3),
            "capacity": round(r.capacity, 3),
            "highwater": round(r.highwater, 3),
            "drops": round(r.drops, 3),
            "fill_rate": round(r.fill_rate, 6),
            "drain_rate": round(r.drain_rate, 6),
            "occupancy": round(occ, 6),
            "burn": round(burn, 6),
            "seconds_to_exhaustion": (round(tte, 3)
                                      if tte is not None else None),
            "episodes": r.episodes,
            **({"error": r.error} if r.error else {}),
        }

    def read(self, name: str) -> Dict:
        """The latest observation of one resource — the registry-read
        seam the hand-maintained readouts folded into (the interruption
        queue-depth gauge, the karpenter_api_* queue gauges): the same
        number can never be reported two ways."""
        with self._lock:
            r = self._resources.get(name)
            if r is None:
                return {}
            return self._row_locked(r)

    def table(self) -> List[Dict]:
        """The ranked first-to-break table: finite time-to-exhaustion
        first (soonest break leads), then highest occupancy, then name —
        a stable total order so two polls of a quiet process agree."""
        with self._lock:
            rows = [self._row_locked(r) for r in self._resources.values()]

        def key(row):
            tte = row["seconds_to_exhaustion"]
            return (0 if tte is not None else 1,
                    tte if tte is not None else 0.0,
                    -row["occupancy"], row["resource"])

        return sorted(rows, key=key)

    # ---- surfaces ----------------------------------------------------------

    def stats(self) -> Dict:
        """The ``headroom`` introspection provider: summary numerics
        plus per-resource occupancy/depth keys so the sampler rings (and
        soak artifacts) carry the saturation trajectory for free."""
        self.observe()
        table = self.table()
        finite = [row for row in table
                  if row["seconds_to_exhaustion"] is not None]
        saturated = sum(1 for row in table
                        if row["kind"] == "queue" and row["capacity"] > 0
                        and row["depth"] >= row["capacity"])
        out: Dict = {
            "resources": float(len(table)),
            "probe_errors": float(self.probe_errors),
            "episodes": float(sum(row["episodes"] for row in table)),
            "saturated": float(saturated),
            "high_water_fraction": self.high_water_fraction,
            # -1 = nothing forecast to break (the JSON-safe infinity)
            "min_tte_seconds": (finite[0]["seconds_to_exhaustion"]
                                if finite else -1.0),
            "first_to_break": (finite[0]["resource"] if finite else ""),
        }
        for row in table:
            out[f"{row['resource']}_depth"] = row["depth"]
            out[f"{row['resource']}_occ"] = row["occupancy"]
            out[f"{row['resource']}_drops"] = row["drops"]
        return out

    def doc(self) -> Dict:
        """The /debug/headroom JSON document (both HTTP servers)."""
        self.observe()
        return {
            "enabled": True,
            "now": round(float(self._clock.now()), 3),
            "high_water_fraction": self.high_water_fraction,
            "tau_seconds": self.tau_seconds,
            "probe_errors": self.probe_errors,
            "resources": self.table(),
        }
