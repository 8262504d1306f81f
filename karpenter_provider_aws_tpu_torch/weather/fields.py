"""The stochastic weather fields: spot market walk + ICE probability.

Both fields are pure state machines advanced one tick at a time by the
simulator; every random draw comes from the per-tick RNG the simulator
hands in, in a FIXED iteration order (sorted key lists), so the field
trajectory is a deterministic function of ``(scenario, seed)``. Nothing
here touches the control plane — the simulator applies the field state
through the pricing provider / cloud / ICE cache seams.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, List, Tuple

from ..lattice import catalog as cat
from .scenario import IceSpell, WeatherScenario

Offering = Tuple[str, str, str]          # (capacity_type, type, zone)


class SpotMarketField:
    """Per-(family, zone) log-multiplier over the base spot market,
    evolving as a mean-reverting (Ornstein-Uhlenbeck) walk with regime
    shifts. Families share one walk per zone — real spot markets move
    capacity-pool-wise, and it keeps the field at ~hundreds of states
    instead of per-type thousands while ``prices()`` still re-prices
    every (type, zone) offering from its own base."""

    def __init__(self, lattice, scenario: WeatherScenario):
        self.scenario = scenario
        self._theta = scenario.market_theta
        self._sigma = scenario.market_sigma
        try:
            ci = lattice.capacity_types.index("spot")
        except ValueError:
            ci = None
        # base spot price per (type, zone), availability-filtered; reads
        # the spec's data-carried per-AZ price (spot_price_in — the
        # weather-repricing hot path its zone-map memo exists for) with
        # the synthetic discount model as fallback, exactly like the
        # lattice build
        self.base: Dict[Tuple[str, str], float] = {}
        self._fam_of: Dict[str, str] = {}
        if ci is not None:
            for ti, spec in enumerate(lattice.specs):
                self._fam_of[spec.name] = spec.family
                for zi, zone in enumerate(lattice.zones):
                    if not lattice.available[ti, zi, ci]:
                        continue
                    sp = spec.spot_price_in(zone)
                    self.base[(spec.name, zone)] = (
                        sp if sp is not None else cat.spot_price(spec, zone))
        # one walk per (family, zone) that has any spot offering
        self.keys: List[Tuple[str, str]] = sorted(
            {(self._fam_of[t], z) for (t, z) in self.base})
        self.x: Dict[Tuple[str, str], float] = {k: 0.0 for k in self.keys}

    def step(self, rng, mu_by_key: Dict[Tuple[str, str], float]) -> None:
        """One tick of the walk. ``mu_by_key`` carries the active regime
        targets; keys absent fall back to the scenario's base mu."""
        base_mu = self.scenario.market_mu
        for k in self.keys:
            mu = mu_by_key.get(k, base_mu)
            self.x[k] += (self._theta * (mu - self.x[k])
                          + self._sigma * rng.gauss(0.0, 1.0))

    def prices(self) -> Dict[Tuple[str, str], float]:
        """The full re-priced spot surface: {(type, zone): $/hr}."""
        fam = self._fam_of
        x = self.x
        return {(t, z): round(p * math.exp(x[(fam[t], z)]), 6)
                for (t, z), p in self.base.items()}

    def multiplier_stats(self) -> Tuple[float, float]:
        """(mean, max) price multiplier across the walks."""
        if not self.keys:
            return 1.0, 1.0
        mults = [math.exp(v) for v in self.x.values()]
        return sum(mults) / len(mults), max(mults)

    def digest(self) -> str:
        """Deterministic fingerprint of the walk state — what the
        timeline records per reprice so same-seed replays can be
        compared byte-for-byte without carrying thousands of prices."""
        h = hashlib.sha256()
        for k in self.keys:
            h.update(f"{k[0]}|{k[1]}|{self.x[k]:.9f};".encode())
        return h.hexdigest()[:16]


class IceField:
    """The insufficient-capacity field: while a spell is active, ~rate
    matching offerings per tick are chosen (deterministically, from the
    lattice's static offering list) and held out of the market for a
    deterministic number of ticks."""

    def __init__(self, lattice, scenario: WeatherScenario):
        self.scenario = scenario
        # static offering universe, sorted for deterministic sampling
        self._fam_of = {s.name: s.family for s in lattice.specs}
        self._universe: List[Offering] = []
        for ci, ct in enumerate(lattice.capacity_types):
            for ti, name in enumerate(lattice.names):
                for zi, zone in enumerate(lattice.zones):
                    if lattice.available[ti, zi, ci]:
                        self._universe.append((ct, name, zone))
        self._universe.sort()
        self._eligible: Dict[int, List[Offering]] = {}   # per spell index

    def _spell_pool(self, idx: int, spell: IceSpell) -> List[Offering]:
        pool = self._eligible.get(idx)
        if pool is None:
            pool = [o for o in self._universe
                    if o[0] in spell.capacity_types
                    and (not spell.zones or o[2] in spell.zones)
                    and (not spell.families
                         or self._fam_of[o[1]] in spell.families)]
            self._eligible[idx] = pool
        return pool

    def sample(self, rng, idx: int, spell: IceSpell,
               held: Dict[Offering, int], tick: int,
               tick_seconds: float) -> List[Tuple[Offering, int]]:
        """Choose this tick's newly-ICE'd offerings for one active spell:
        [(offering, thaw_tick)]. Consumes a FIXED number of rng draws per
        chosen offering, independent of control-plane state."""
        pool = self._spell_pool(idx, spell)
        if not pool:
            return []
        whole = int(spell.rate)
        k = whole + (1 if rng.random() < spell.rate - whole else 0)
        out: List[Tuple[Offering, int]] = []
        chosen = set()
        for _ in range(k):
            o = pool[rng.randrange(len(pool))]
            hold_s = spell.hold_seconds * (0.5 + rng.random())
            if o in held or o in chosen:
                # already iced (or drawn twice this tick): the draws
                # still happened (determinism), but the offering must
                # not double-count ice_marks / the timeline entry
                continue
            chosen.add(o)
            thaw = tick + max(1, int(hold_s / tick_seconds))
            out.append((o, thaw))
        return out
