"""Weather scenarios: the declarative half of the adversarial suite.

A scenario is a small, fully-serializable schedule of market and chaos
phases (docs/reference/weather.md): a mean-reverting spot-price walk
with regime shifts, ICE (insufficient-capacity) spells, correlated
interruption storms, and device weather. Everything the simulator does
is a pure function of ``(scenario, seed, tick)`` — two runs with the
same scenario JSON and seed produce byte-identical weather timelines,
which is what makes a chaos soak REPLAYABLE instead of anecdotal.

Named scenarios (``calm``, ``squall``, ``spot-crash``, ``ice-age``,
``storm-front``) are constructed here; ``tools/soak.py --weather`` and
the CI squall smoke accept either a name or a path to a scenario JSON
file produced by :meth:`WeatherScenario.to_json`.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Dict, Tuple

# the storm/ICE zone palette used by the named scenarios — the standard
# availability zones of the synthetic catalog (lattice/catalog.py ZONES
# minus the local zone, which has no spot market to storm on)
_STD_ZONES = ("us-west-2a", "us-west-2b", "us-west-2c")


@dataclass(frozen=True)
class Regime:
    """A spot-market regime shift: from ``at`` onward, matching
    (family, zone) walks revert toward ``mu`` (log-space; 0.0 = the base
    market, ``ln 2`` = prices doubling). Later regimes override earlier
    ones for the keys they match."""

    at: float                           # seconds from scenario start
    mu: float                           # log-multiplier reversion target
    families: Tuple[str, ...] = ()      # () = every family
    zones: Tuple[str, ...] = ()         # () = every zone


@dataclass(frozen=True)
class Storm:
    """A correlated interruption storm over ``zones`` × ``families``:
    every tick in [at, at+duration) bursts EventBridge messages at
    matching live spot instances (all four schemas), optionally mixed
    with junk bodies and device weather."""

    at: float
    duration: float
    zones: Tuple[str, ...] = ()
    families: Tuple[str, ...] = ()
    intensity: float = 0.25             # P(message for a matching instance)/tick
    junk_rate: float = 0.0              # expected malformed/unknown bodies/tick
    device_error_rate: float = 0.0      # P(device-error burst)/tick
    device_errors: int = 3              # injected per burst (3 ⇒ retry exhausts
                                        # and the host-FFD rung engages)


@dataclass(frozen=True)
class IceSpell:
    """An insufficient-capacity spell: while active, ~``rate`` matching
    offerings per tick are pulled from the market (FakeCloud capacity 0
    + an UnavailableOfferings mark) and held for a deterministic number
    of ticks before thawing."""

    at: float
    duration: float
    rate: float = 1.0                   # expected newly-ICE'd offerings/tick
    zones: Tuple[str, ...] = ()
    families: Tuple[str, ...] = ()
    capacity_types: Tuple[str, ...] = ("spot",)
    hold_seconds: float = 60.0          # mean hold before a pool thaws


@dataclass(frozen=True)
class SidecarOutage:
    """CONTROL-PLANE weather (docs/reference/solver-pool.md): while
    active, one solver-pool endpoint misbehaves. Modes:

    - ``kill``: the endpoint goes dark (connection refused); with
      ``restart_after`` (default) it restarts when the window closes —
      the breaker's half-open probe must then re-close it;
    - ``hang``: the endpoint ACCEPTS the RPC and stalls past every
      deadline — the failure a connect error never exercises;
    - ``junk``: the endpoint answers bytes that are not a NodePlan.

    Purely deterministic (no RNG): the timeline records outage/restore
    on the ticks the window edges cross, exactly like storms."""

    at: float
    duration: float
    endpoint: int = 0                   # index into the pool's endpoint list
    mode: str = "kill"                  # kill | hang | junk
    restart_after: bool = True          # kill mode: restart at window end


@dataclass(frozen=True)
class OperatorKill:
    """OPERATOR weather (docs/reference/handoff.md): at ``at`` seconds
    the targeted operator runtime dies mid-storm. Modes:

    - ``kill``: crash semantics — the runtime crash-stops WITHOUT
      releasing its lease (a kill -9 never runs the shutdown path), so
      the standby must wait out the lease duration before promoting;
    - ``hang``: the runtime's threads freeze in place — renewal stops,
      the lease expires, a standby promotes, and when the window closes
      (``restart_after``) the zombie resumes straight into the write
      fence, where its queued side effects are rejected.

    Deterministic like :class:`SidecarOutage`: the timeline records
    kill/restore on the ticks the window edges cross. ``restart_after``
    defaults to False — a killed leader staying dead is the handoff
    acceptance shape (the standby must carry the rest of the run)."""

    at: float
    duration: float
    target: int = 0                     # index into the operator-handle list
    mode: str = "kill"                  # kill | hang
    restart_after: bool = False


@dataclass
class WeatherScenario:
    name: str = "custom"
    seed: int = 0
    tick_seconds: float = 2.0
    duration_seconds: float = 240.0     # advisory run length (harnesses may
                                        # run longer; the schedule just ends)
    # the market walk: per-(family, zone) log-multiplier x evolving as
    # x += theta * (mu - x) + sigma * N(0, 1) each tick
    market_theta: float = 0.15
    market_sigma: float = 0.04
    market_mu: float = 0.0
    reprice_every: int = 1              # ticks between pushes to the lattice
    regimes: Tuple[Regime, ...] = ()
    storms: Tuple[Storm, ...] = ()
    ice: Tuple[IceSpell, ...] = ()
    sidecar_outages: Tuple[SidecarOutage, ...] = ()
    operator_kills: Tuple[OperatorKill, ...] = ()

    # ---- serialization (replayable byte-for-byte from a seed) -----------

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)

    def to_json(self, indent: int = 1) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    @classmethod
    def from_dict(cls, d: Dict) -> "WeatherScenario":
        def tup(xs, typ):
            return tuple(typ(**{k: (tuple(v) if isinstance(v, list) else v)
                                for k, v in x.items()}) for x in xs or ())
        kw = dict(d)
        kw["regimes"] = tup(kw.get("regimes"), Regime)
        kw["storms"] = tup(kw.get("storms"), Storm)
        kw["ice"] = tup(kw.get("ice"), IceSpell)
        if "sidecar_outages" in kw:   # absent in pre-PR-13 scenario JSON
            kw["sidecar_outages"] = tup(kw.get("sidecar_outages"),
                                        SidecarOutage)
        if "operator_kills" in kw:    # absent in pre-PR-17 scenario JSON
            kw["operator_kills"] = tup(kw.get("operator_kills"),
                                       OperatorKill)
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(kw) - known
        if unknown:
            raise ValueError(f"unknown scenario fields: {sorted(unknown)}")
        return cls(**kw)

    @classmethod
    def from_json(cls, text: str) -> "WeatherScenario":
        return cls.from_dict(json.loads(text))


def named(name: str) -> WeatherScenario:
    """The built-in scenario library (docs/reference/weather.md)."""
    if name == "calm":
        # fair weather: a barely-drifting market, no chaos — the control
        # run the stormy artifacts are compared against
        return WeatherScenario(name="calm", market_sigma=0.01)
    if name == "squall":
        # one short, violent storm mid-run, then recovery — the CI gate
        # (tools/smoke_weather.py): 60 s on FakeClock, ladder must engage
        # and the burn must recover after the front passes
        return WeatherScenario(
            name="squall", tick_seconds=1.0, duration_seconds=60.0,
            market_sigma=0.03,
            storms=(Storm(at=20.0, duration=15.0,
                          zones=_STD_ZONES[:2], intensity=0.5,
                          junk_rate=0.5, device_error_rate=0.6),),
            ice=(IceSpell(at=20.0, duration=15.0, rate=1.0,
                          zones=_STD_ZONES[:2], hold_seconds=20.0),))
    if name == "spot-crash":
        # the spot market for the workhorse families triples, then
        # mean-reverts: consolidation must chase the moving price field
        # without burning the 2% cost budget
        crash = 1.1     # ln-multiplier ≈ 3.0x
        return WeatherScenario(
            name="spot-crash", market_sigma=0.06,
            regimes=(Regime(at=50.0, mu=crash,
                            families=("m5", "c5", "r5")),
                     Regime(at=170.0, mu=0.0)))
    if name == "ice-age":
        # sustained capacity scarcity: a long, broad ICE spell — the
        # solver keeps placing around a shrinking offering set
        return WeatherScenario(
            name="ice-age", market_sigma=0.03,
            ice=(IceSpell(at=30.0, duration=170.0, rate=2.0,
                          capacity_types=("spot", "on-demand"),
                          hold_seconds=90.0),))
    if name == "storm-front":
        # the acceptance scenario: a front marching zone by zone —
        # correlated interruption storms with junk and device weather,
        # ICE trailing each storm, and a price spike while capacity is
        # being reclaimed. Every rung of the ladder fires.
        storms = tuple(
            Storm(at=30.0 + 50.0 * i, duration=40.0, zones=(z,),
                  intensity=0.35, junk_rate=0.3,
                  device_error_rate=0.4, device_errors=3)
            for i, z in enumerate(_STD_ZONES))
        spells = tuple(
            IceSpell(at=30.0 + 50.0 * i, duration=40.0, rate=2.0,
                     zones=(z,), hold_seconds=45.0)
            for i, z in enumerate(_STD_ZONES))
        return WeatherScenario(
            name="storm-front", market_sigma=0.05,
            regimes=(Regime(at=30.0, mu=0.6),   # ≈1.8x while the front rages
                     Regime(at=185.0, mu=0.0)),
            storms=storms, ice=spells)
    if name == "blackout":
        # control-plane weather against a 2-sidecar solver pool
        # (docs/reference/solver-pool.md): endpoint 0 dies outright and
        # endpoint 1 HANGS while 0 is still dark — a full-pool blackout
        # window (30-45 s) where the local solve is the only rung —
        # then 1 recovers, 0 restarts (breaker must re-close via the
        # half-open probe), and a late junk-response spell on 1 forces
        # failovers onto the recovered 0. Market stays mild: the
        # artifact isolates the control plane's own failure ladder.
        return WeatherScenario(
            name="blackout", tick_seconds=1.0, duration_seconds=120.0,
            market_sigma=0.02,
            sidecar_outages=(
                SidecarOutage(at=15.0, duration=40.0, endpoint=0,
                              mode="kill"),
                SidecarOutage(at=30.0, duration=15.0, endpoint=1,
                              mode="hang"),
                SidecarOutage(at=75.0, duration=15.0, endpoint=1,
                              mode="junk"),
            ))
    if name == "handoff":
        # the operator-handoff acceptance scenario (docs/reference/
        # handoff.md): a violent squall-class storm is raging when the
        # ACTIVE OPERATOR is killed outright mid-storm (no restart — a
        # dead leader stays dead). The warm standby must wait out the
        # lease, pass the bounded-staleness gate, promote behind the
        # write fence, sweep the blackout window's orphaned leases, and
        # carry the rest of the storm within the SLO budget. Market
        # stays mild: the artifact isolates the handoff itself.
        return WeatherScenario(
            name="handoff", tick_seconds=1.0, duration_seconds=120.0,
            market_sigma=0.02,
            storms=(Storm(at=25.0, duration=40.0, zones=_STD_ZONES[:2],
                          intensity=0.35, junk_rate=0.2),),
            ice=(IceSpell(at=25.0, duration=30.0, rate=1.0,
                          zones=_STD_ZONES[:1], hold_seconds=20.0),),
            operator_kills=(OperatorKill(at=45.0, duration=60.0,
                                         target=0, mode="kill"),))
    raise ValueError(f"unknown weather scenario {name!r} "
                     f"(named: {', '.join(NAMED_SCENARIOS)})")


NAMED_SCENARIOS = ("calm", "squall", "spot-crash", "ice-age",
                   "storm-front", "blackout", "handoff")


def load_scenario(spec: str) -> WeatherScenario:
    """A named scenario, or a path to a scenario JSON file."""
    if spec in NAMED_SCENARIOS:
        return named(spec)
    from pathlib import Path
    p = Path(spec)
    if p.exists():
        return WeatherScenario.from_json(p.read_text())
    raise ValueError(f"--weather {spec!r}: not a named scenario "
                     f"({', '.join(NAMED_SCENARIOS)}) and no such file")
