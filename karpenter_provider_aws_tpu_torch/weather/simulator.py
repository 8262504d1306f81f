"""The weather simulator: deterministic chaos over the control plane.

One object composes every adversarial seam the repo already has into a
single clock-driven system (docs/reference/weather.md):

- **spot market**: the :class:`~.fields.SpotMarketField` walk pushes
  re-priced spot surfaces through ``PricingProvider.update_spot_pricing``
  — the lattice's price tensor is rewritten in place and
  ``price_version`` bumps, so the solver's masked-view memo, the
  incremental builder's gate ladder, and the device-resident problem
  state all re-tensorize exactly as they would for a live pricing feed;
- **ICE field**: chosen offerings get ``FakeCloud`` capacity 0 (ground
  truth — launches into them fail and feed the provider's own ICE
  handling) AND an ``UnavailableOfferings`` mark (the learned state the
  next solve masks on);
- **interruption storms**: bursts of all four EventBridge schemas
  (``interruption/messages.py``) at live spot instances correlated by
  zone/family, plus junk bodies that must be counted-and-dropped;
- **device weather**: retryable device failures via the solver's
  ``FaultInjector`` (merged, never replacing an operator-applied one —
  ``--fault-schedule`` and ``--weather`` compose).

Everything the simulator DECIDES is a pure function of ``(scenario,
seed, tick)``: per-tick RNGs are derived as ``Random(f"{seed}:{tick}")``
(plus a separate ``:live`` stream for draws whose COUNT depends on live
control-plane state, so instance-targeted sampling can never desync the
deterministic stream). The recorded ``timeline`` contains only the
deterministic decisions — :meth:`WeatherSimulator.replay` re-derives it
with no control plane attached, which is how a soak proves its weather
was reproducible.

Driven off the shared ``Clock``: ``advance()`` converts elapsed clock
time into tick numbers and steps any missed ticks sequentially, so a
``FakeClock`` CI smoke and a wall-clock soak run ONE code path.
"""

from __future__ import annotations

import random
import threading
from typing import Dict, List, Optional, Tuple

from ..utils.clock import Clock
from .fields import IceField, Offering, SpotMarketField
from .scenario import WeatherScenario

_ICE_REASON = "WeatherIce"

# consolidation_advisory's spot-crash detector: a regime target μ (log
# price multiplier) at or past this reads as distressed spot capacity
# (e^0.5 ≈ a sustained 1.65× surge) — voluntary consolidation holds
CONSOL_HOLD_MU = 0.5


class WeatherSimulator:
    def __init__(self, scenario: WeatherScenario, lattice,
                 seed: Optional[int] = None, clock: Optional[Clock] = None,
                 pricing=None, cloud=None, unavailable=None, queue=None,
                 solver=None, metrics=None, sidecars=None, operators=None):
        """Every control-plane seam is optional: with all of them None
        the simulator is a pure replay engine (timeline only).

        ``sidecars`` is the control-plane-weather seam: a
        sequence of handles with ``kill()/restart()/set_hang()/
        set_junk()`` (parallel/sidecar.py ChaosSidecar) that scenario
        ``SidecarOutage`` elements drive — one handle per solver-pool
        endpoint index. An outage naming an endpoint beyond the list is
        recorded in the timeline but applies to nothing (the timeline
        stays a pure function of the scenario either way).

        ``operators`` is the operator-weather seam (handoff chaos): a
        sequence of handles with ``kill()/restart()/set_hang()/
        restore()`` (tools/soak.py OperatorHandle over a
        ControllerRuntime) that scenario ``OperatorKill`` elements
        drive — one handle per operator index. Same out-of-range /
        pure-replay semantics as ``sidecars``."""
        self.scenario = scenario
        self.seed = scenario.seed if seed is None else int(seed)
        self.lattice = lattice
        self.clock = clock or Clock()
        self.pricing = pricing
        self.cloud = cloud
        self.unavailable = unavailable
        self.queue = queue
        self.solver = solver
        self.sidecars = list(sidecars) if sidecars else []
        self.operators = list(operators) if operators else []
        self.market = SpotMarketField(lattice, scenario)
        self.ice = IceField(lattice, scenario)
        self._fam_of = {s.name: s.family for s in lattice.specs}
        self.timeline: List[Dict] = []
        self.counters: Dict[str, int] = {
            "reprices": 0, "regime_shifts": 0, "storm_ticks": 0,
            "messages_sent": 0, "spot_interruptions": 0, "rebalances": 0,
            "scheduled_changes": 0, "state_changes": 0, "junk_sent": 0,
            "ice_marks": 0, "ice_thaws": 0, "device_errors": 0,
            "sidecar_outages": 0, "sidecar_restores": 0,
            "operator_kills": 0, "operator_restores": 0,
        }
        self.ticks = 0
        self._t0: Optional[float] = None
        self._stopped = False
        self._lock = threading.Lock()
        # active regime targets per (family, zone); later shifts override
        self._mu: Dict[Tuple[str, str], float] = {}
        self._held: Dict[Offering, int] = {}     # offering -> thaw tick
        self._gauges = None
        if metrics is not None:
            from ..metrics import wire_core_metrics
            m = wire_core_metrics(metrics)
            self._gauges = {
                "storm": m["weather_storm_active"],
                "ice": m["weather_ice_pools"],
                "mult_mean": m["weather_spot_mult_mean"],
                "mult_max": m["weather_spot_mult_max"],
                "ticks": m["weather_ticks"],
                "events": m["weather_events"],
            }

    # ---- drive ----------------------------------------------------------

    def start(self) -> "WeatherSimulator":
        self._t0 = self.clock.monotonic()
        return self

    def advance(self) -> int:
        """Step every tick the clock has reached since the last call
        (0 or more). The soak churn loop and the FakeClock smoke both
        call this once per iteration — one code path."""
        with self._lock:
            if self._t0 is None:
                self._t0 = self.clock.monotonic()
            want = int((self.clock.monotonic() - self._t0)
                       / self.scenario.tick_seconds)
            stepped = 0
            while self.ticks < want:
                self._step_tick()
                stepped += 1
            return stepped

    def step(self, n: int = 1) -> None:
        """Step exactly ``n`` ticks regardless of the clock (replay and
        deterministic tests)."""
        with self._lock:
            for _ in range(n):
                self._step_tick()

    # ---- one tick -------------------------------------------------------

    def _event(self, kind: str, **payload) -> None:
        e = {"tick": self.ticks, "kind": kind}
        e.update(payload)
        self.timeline.append(e)
        if self._gauges is not None:
            self._gauges["events"].inc(kind=kind)

    def _step_tick(self) -> None:
        sc = self.scenario
        t = self.ticks
        now_s = t * sc.tick_seconds
        prev_s = now_s - sc.tick_seconds
        rng = random.Random(f"{self.seed}:{t}")

        # 1. regime shifts crossing into this tick
        for r in sc.regimes:
            if prev_s < r.at <= now_s or (t == 0 and r.at <= 0):
                matched = 0
                for fam, zone in self.market.keys:
                    if ((not r.families or fam in r.families)
                            and (not r.zones or zone in r.zones)):
                        self._mu[(fam, zone)] = r.mu
                        matched += 1
                if matched == 0:
                    # a regime whose filter matches no market walk never
                    # activated: don't count or record it — the soak's
                    # regime non-vacuity gate must not be satisfiable by
                    # a filter that named families/zones the lattice
                    # doesn't carry
                    continue
                self.counters["regime_shifts"] += 1
                self._event("regime", at=r.at, mu=r.mu,
                            families=list(r.families), zones=list(r.zones))

        # 2. market walk + reprice
        self.market.step(rng, self._mu)
        if sc.reprice_every and t % sc.reprice_every == 0:
            self.counters["reprices"] += 1
            self._event("reprice", digest=self.market.digest())
            if self.pricing is not None:
                self.pricing.update_spot_pricing(self.market.prices())

        # 3. ICE field: thaw expired holds, then sample active spells
        thawed = sorted(o for o, thaw in self._held.items() if thaw <= t)
        if thawed:
            for o in thawed:
                del self._held[o]
            self.counters["ice_thaws"] += len(thawed)
            self._event("ice-thaw", pools=[list(o) for o in thawed])
            if self.cloud is not None:
                for ct, it, z in thawed:
                    self.cloud.clear_capacity(ct, it, z)
            if self.unavailable is not None:
                for ct, it, z in thawed:
                    self.unavailable.delete(ct, it, z)
        for i, spell in enumerate(sc.ice):
            if not (spell.at <= now_s < spell.at + spell.duration):
                continue
            new = self.ice.sample(rng, i, spell, self._held, t,
                                  sc.tick_seconds)
            if not new:
                continue
            self._held.update(new)
            self.counters["ice_marks"] += len(new)
            self._event("ice", pools=[list(o) for o, _ in new])
            if self.unavailable is not None:
                for (ct, it, z), _ in new:
                    self.unavailable.mark_unavailable(_ICE_REASON, ct, it, z)
        if self.cloud is not None:
            # re-assert the hold every tick: instance terminations hand
            # capacity back to pools they came from (cloud/fake.py), and a
            # weather-held pool must stay dry until its thaw tick
            for ct, it, z in self._held:
                self.cloud.set_capacity(ct, it, z, 0)

        # 4. storms. Events always pair: begin fires on the tick the
        # window opens, end on the tick its close crosses — a storm
        # whose whole window falls between two ticks (shorter than
        # tick_seconds) still runs begin → one burst → end on the tick
        # it slips past, never an unpaired end.
        storms_active = 0
        for i, storm in enumerate(sc.storms):
            end_s = storm.at + storm.duration
            started = (prev_s < storm.at <= now_s
                       or (t == 0 and storm.at <= 0))
            active = storm.at <= now_s < end_s
            if started:
                self._event("storm-begin", storm=i,
                            zones=list(storm.zones),
                            families=list(storm.families),
                            intensity=storm.intensity)
            if active or (started and now_s >= end_s):
                storms_active += 1
                self.counters["storm_ticks"] += 1
                self._burst(rng, i, storm)
            if storm.at <= now_s and prev_s < end_s <= now_s:
                self._event("storm-end", storm=i)

        # 4b. sidecar outages (control-plane weather; parallel/pool.py).
        # Purely deterministic — no RNG draw, so the timeline events are
        # a function of (scenario, tick) alone and replay with no
        # sidecar handles attached. Same edge pairing as storms: an
        # outage shorter than tick_seconds still runs
        # outage → restore on the tick it slips past.
        for i, o in enumerate(sc.sidecar_outages):
            end_s = o.at + o.duration
            started = (prev_s < o.at <= now_s or (t == 0 and o.at <= 0))
            if started:
                self.counters["sidecar_outages"] += 1
                self._event("sidecar-outage", outage=i,
                            endpoint=o.endpoint, mode=o.mode)
                self._apply_outage(o)
            if o.at <= now_s and prev_s < end_s <= now_s:
                self.counters["sidecar_restores"] += 1
                self._event("sidecar-restore", outage=i,
                            endpoint=o.endpoint, mode=o.mode)
                self._restore_outage(o)

        # 4c. operator kills (handoff chaos; operator/runtime.py +
        # state/replication.py). Deterministic like 4b: the timeline is
        # a function of (scenario, tick) with or without operator
        # handles attached.
        for i, k in enumerate(sc.operator_kills):
            end_s = k.at + k.duration
            started = (prev_s < k.at <= now_s or (t == 0 and k.at <= 0))
            if started:
                self.counters["operator_kills"] += 1
                self._event("operator-kill", kill=i,
                            target=k.target, mode=k.mode)
                self._apply_opkill(k)
            if k.at <= now_s and prev_s < end_s <= now_s:
                self.counters["operator_restores"] += 1
                self._event("operator-restore", kill=i,
                            target=k.target, mode=k.mode)
                self._restore_opkill(k)

        # 5. device weather (independent draws per active storm, fixed
        # order — deterministic)
        for i, storm in enumerate(sc.storms):
            if not (storm.at <= now_s < storm.at + storm.duration):
                continue
            if storm.device_error_rate and \
                    rng.random() < storm.device_error_rate:
                self.counters["device_errors"] += storm.device_errors
                self._event("device", errors=storm.device_errors)
                if self.solver is not None:
                    inject_device_errors(self.solver, storm.device_errors)

        self.ticks += 1
        if self._gauges is not None:
            mean, mx = self.market.multiplier_stats()
            self._gauges["storm"].set(float(storms_active))
            self._gauges["ice"].set(float(len(self._held)))
            self._gauges["mult_mean"].set(round(mean, 4))
            self._gauges["mult_max"].set(round(mx, 4))
            self._gauges["ticks"].set(float(self.ticks))

    def _apply_outage(self, o) -> None:
        """Drive one SidecarOutage onto its endpoint handle (no-op when
        no handle is attached at that index — pure replay)."""
        if not (0 <= o.endpoint < len(self.sidecars)):
            return
        h = self.sidecars[o.endpoint]
        if o.mode == "kill":
            h.kill()
        elif o.mode == "hang":
            h.set_hang(True)
        elif o.mode == "junk":
            h.set_junk(True)

    def _restore_outage(self, o) -> None:
        if not (0 <= o.endpoint < len(self.sidecars)):
            return
        h = self.sidecars[o.endpoint]
        if o.mode == "kill":
            if o.restart_after:
                h.restart()
        elif o.mode == "hang":
            h.set_hang(False)
        elif o.mode == "junk":
            h.set_junk(False)

    def _apply_opkill(self, k) -> None:
        """Drive one OperatorKill onto its operator handle (no-op when
        no handle is attached at that index — pure replay)."""
        if not (0 <= k.target < len(self.operators)):
            return
        h = self.operators[k.target]
        if k.mode == "kill":
            h.kill()
        elif k.mode == "hang":
            h.set_hang(True)

    def _restore_opkill(self, k) -> None:
        if not (0 <= k.target < len(self.operators)):
            return
        h = self.operators[k.target]
        if k.mode == "kill":
            if k.restart_after:
                h.restart()
        elif k.mode == "hang":
            h.set_hang(False)

    def _burst(self, rng, idx: int, storm) -> None:
        """One storm tick: the deterministic part (junk count, timeline
        entry) draws from ``rng``; instance-targeted sampling draws from
        a per-tick ``:live`` stream so its draw COUNT (a function of how
        many instances happen to exist) can never desync the
        deterministic stream."""
        n_junk = 0
        if storm.junk_rate:
            whole = int(storm.junk_rate)
            n_junk = whole + (1 if rng.random() < storm.junk_rate - whole
                              else 0)
        self._event("storm-burst", storm=idx, junk=n_junk)
        if self.queue is None:
            return
        # storm index in the seed: two storms active on one tick must
        # draw INDEPENDENT sequences, not hit the same instances twice
        live = random.Random(f"{self.seed}:{self.ticks}:{idx}:live")
        from ..interruption.messages import (rebalance_recommendation,
                                             scheduled_change,
                                             spot_interruption, state_change)
        for j in range(n_junk):
            self.counters["junk_sent"] += 1
            self.counters["messages_sent"] += 1
            if (self.ticks + j) % 2 == 0:   # tick-phased: bursts of one
                # junk body still alternate the two junk classes
                # malformed: not even a dict
                self.queue.send(["weather", "junk", self.ticks])
            else:
                # well-formed but unknown (source, detail-type)
                self.queue.send({"version": "0", "source": "chaos.weather",
                                 "detail-type": "Cosmic Ray Notification",
                                 "detail": {"tick": self.ticks}})
        if self.cloud is None:
            return
        fam_of = self._fam_of
        targets = [
            inst for inst in self.cloud.peek_instances()
            if inst.capacity_type == "spot"
            and (not storm.zones or inst.zone in storm.zones)
            and (not storm.families
                 or (fam_of.get(inst.instance_type)
                     or inst.instance_type.split(".")[0])
                 in storm.families)]
        scheduled_batch: List[str] = []
        for inst in targets:
            if live.random() >= storm.intensity:
                continue
            roll = live.random()
            self.counters["messages_sent"] += 1
            if roll < 0.70:
                self.counters["spot_interruptions"] += 1
                self.queue.send(spot_interruption(inst.id))
            elif roll < 0.85:
                self.counters["rebalances"] += 1
                self.queue.send(rebalance_recommendation(inst.id))
            elif roll < 0.95:
                self.counters["state_changes"] += 1
                self.queue.send(state_change(inst.id, "stopping"))
            else:
                scheduled_batch.append(inst.id)
        if scheduled_batch:
            # health events arrive batched over affected entities
            self.counters["scheduled_changes"] += 1
            self.queue.send(scheduled_change(*scheduled_batch))

    # ---- teardown / restore --------------------------------------------

    def stop(self) -> None:
        """Restore fair weather: thaw every held pool, return the spot
        surface to its base prices (one more ``price_version`` bump so
        downstream memos re-key), and return the live gauges to their
        fair-weather readings (storms/ICE 0, multipliers 1.0 — the
        scrape must agree with the restored lattice; ``ticks`` keeps its
        final value, it is the timeline index). Injected device faults
        are NOT cleared here — the fault injector may be shared with
        ``--fault-schedule``; harnesses clear it explicitly at
        convergence."""
        with self._lock:
            self._stopped = True
            held = sorted(self._held)
            self._held.clear()
            if self.cloud is not None:
                for ct, it, z in held:
                    self.cloud.clear_capacity(ct, it, z)
            if self.unavailable is not None:
                for ct, it, z in held:
                    self.unavailable.delete(ct, it, z)
            if self.pricing is not None and self.market.base:
                self.pricing.update_spot_pricing(dict(self.market.base))
            # control-plane weather clears with the rest: every sidecar
            # handle returns to fair weather (alive, no hang/junk) so
            # the convergence tail runs against a healthy pool
            for h in self.sidecars:
                h.restore()
            # operator handles are deliberately NOT restored: a killed
            # leader staying dead is the handoff acceptance shape — the
            # promoted standby carries the convergence tail (a hung
            # runtime still stops cleanly; pause never blocks stop)
            if self._gauges is not None:
                self._gauges["storm"].set(0.0)
                self._gauges["ice"].set(0.0)
                self._gauges["mult_mean"].set(1.0)
                self._gauges["mult_max"].set(1.0)

    # ---- introspection --------------------------------------------------

    def stats(self) -> Dict:
        """The ``weather`` provider for the introspection registry (and
        the WEATHER row in ``kpctl top``)."""
        sc = self.scenario
        if self._stopped:
            # every live surface must agree after stop(): the lattice is
            # restored, the gauges read fair weather — so does this
            # provider (the recorded counters/timeline stay as evidence)
            mean = mx = 1.0
            active = 0
        else:
            mean, mx = self.market.multiplier_stats()
            now_s = self.ticks * sc.tick_seconds
            active = sum(1 for s in sc.storms
                         if s.at <= now_s < s.at + s.duration)
        out: Dict = {
            "scenario": sc.name,
            "seed": self.seed,
            "ticks": self.ticks,
            "storms_active": active,
            "ice_pools": len(self._held),
            "spot_mult_mean": round(mean, 4),
            "spot_mult_max": round(mx, 4),
            "timeline_events": len(self.timeline),
        }
        out.update(self.counters)
        return out

    def consolidation_advisory(self) -> Dict[str, object]:
        """Should voluntary consolidation HOLD right now? The engine's
        weather gate (solver/consolidate.py): consolidating INTO an
        active storm window or a spot-crash regime trades a standing
        node for capacity about to be reclaimed or repriced. Returns
        ``{"hold": bool, "reason": "storm" | "spot-crash" | ""}``.

        ICE spells deliberately never hold — an ice-age holds capacity
        OUT of the market, which makes consolidating onto what remains
        MORE valuable, not less. A crash regime is detected from the
        live regime targets (``_mu``): any family/zone pushed past
        :data:`CONSOL_HOLD_MU` (≈ a sustained 1.6× price surge) reads
        as distressed spot capacity."""
        if self._stopped:
            return {"hold": False, "reason": ""}
        sc = self.scenario
        now_s = self.ticks * sc.tick_seconds
        if any(s.at <= now_s < s.at + s.duration for s in sc.storms):
            return {"hold": True, "reason": "storm"}
        if any(mu >= CONSOL_HOLD_MU for mu in self._mu.values()):
            return {"hold": True, "reason": "spot-crash"}
        return {"hold": False, "reason": ""}

    def artifact(self, **extra) -> Dict:
        """The WEATHER artifact body (docs/reference/weather.md): the
        scenario, the deterministic timeline, the runtime counters, and
        whatever verdict fields the harness adds."""
        doc = {
            "scenario": self.scenario.to_dict(),
            "seed": self.seed,
            "ticks": self.ticks,
            "timeline": list(self.timeline),
            "counters": dict(self.counters),
        }
        doc.update(extra)
        return doc

    # ---- replay ---------------------------------------------------------

    @classmethod
    def replay(cls, scenario: WeatherScenario, lattice, ticks: int,
               seed: Optional[int] = None) -> List[Dict]:
        """Re-derive the deterministic weather timeline with no control
        plane attached: same scenario + seed + tick count ⇒ identical
        timeline, byte for byte. A soak's replay check compares this
        against the timeline its live run recorded."""
        sim = cls(scenario, lattice, seed=seed)
        sim.step(ticks)
        return sim.timeline


def inject_device_errors(solver, n: int) -> None:
    """Merge ``n`` device-error injections into the solver's (possibly
    operator-owned) FaultInjector — shared with tools/soak.py's
    ``--fault-schedule`` so the two compose instead of clobbering each
    other. Mutation takes the injector's own lock: the operator thread
    consumes device_errors concurrently via take_device_error."""
    from ..solver import FaultInjector
    inj = solver.faults or FaultInjector()
    with inj._lock:
        inj.device_errors += n
    solver.inject_faults(inj)
