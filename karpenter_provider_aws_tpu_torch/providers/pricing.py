"""Pricing provider.

Mirror of reference pkg/providers/pricing/pricing.go: on-demand prices
(parallel standard+metal fetch, :150-217), per-zone spot prices
(:348-391), and compiled-in static fallback for air-gapped operation
(:43, :411-423 — here the catalog's generated prices ARE the static
table). Dynamic updates overlay the static base and rebuild the lattice's
price tensor so the device solver prices with live data.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

import numpy as np

from ..lattice import catalog as cat
from ..lattice.tensors import Lattice
from ..utils.clock import Clock
from ..utils.logging import ChangeMonitor, get_logger

PRICING_REFRESH_SECONDS = 12 * 3600.0  # 12h loop (pricing controller.go:56)


class PricingProvider:
    def __init__(self, lattice: Lattice, clock: Optional[Clock] = None,
                 isolated_vpc: bool = False):
        self.lattice = lattice
        self.clock = clock or Clock()
        # isolated VPC: the Pricing API has no VPC endpoint, so live OD
        # lookups are skipped and static prices serve (options.go:53)
        self.isolated_vpc = isolated_vpc
        self._lock = threading.Lock()
        self._log = get_logger("pricing")
        # log-on-delta (reference instancetype.go:150-152 idiom): a 12h
        # refresh loop re-asserting identical prices stays quiet
        self._monitor = ChangeMonitor(self.clock)
        # static fallback = the catalog prices compiled into the lattice
        self._static = lattice.price.copy()
        self._od_overrides: Dict[str, float] = {}                  # type -> $/hr
        self._spot_overrides: Dict[Tuple[str, str], float] = {}    # (type, zone) -> $/hr
        self.last_update: Optional[float] = None

    def on_demand_price(self, instance_type: str) -> float:
        with self._lock:
            if instance_type in self._od_overrides:
                return self._od_overrides[instance_type]
        lat = self.lattice
        ti = lat.name_to_idx.get(instance_type)
        if ti is None:
            return float("inf")
        ci = lat.capacity_types.index("on-demand")
        return float(np.min(self._static[ti, :, ci]))

    def spot_price(self, instance_type: str, zone: str) -> float:
        with self._lock:
            if (instance_type, zone) in self._spot_overrides:
                return self._spot_overrides[(instance_type, zone)]
        lat = self.lattice
        ti = lat.name_to_idx.get(instance_type)
        if ti is None or zone not in lat.zones:
            return float("inf")
        zi = lat.zones.index(zone)
        ci = lat.capacity_types.index("spot")
        return float(self._static[ti, zi, ci])

    def update_on_demand_pricing(self, prices: Dict[str, float]) -> int:
        """Overlay live OD prices (the 12h Pricing-API fetch)."""
        if self.isolated_vpc:
            # the Pricing API has no VPC endpoint: static prices serve
            # (reference pricing.go:150-163)
            if self._monitor.has_changed("isolated-od", True):
                self._log.debug("isolated VPC: on-demand pricing not updated")
            return 0
        with self._lock:
            self._od_overrides.update(prices)
            self.last_update = self.clock.now()
            # gate on the RESULTING overlay state, not the call payload
            # (partial re-sends of effective prices stay quiet) — decided
            # under the lock so concurrent updates can't log stale state
            changed = self._monitor.has_changed(
                "od-prices", tuple(sorted(self._od_overrides.items())))
            n = len(self._od_overrides)
        self._rebuild()
        if changed:
            self._log.info("updated on-demand pricing", entries=n)
        return len(prices)

    def update_spot_pricing(self, prices: Dict[Tuple[str, str], float]) -> int:
        """Overlay live per-zone spot prices (DescribeSpotPriceHistory —
        an EC2 API with a VPC endpoint, so isolated VPCs still get it,
        reference pricing.go:348-391 UpdateSpotPricing has no gate)."""
        with self._lock:
            self._spot_overrides.update(prices)
            self.last_update = self.clock.now()
            changed = self._monitor.has_changed(
                "spot-prices", tuple(sorted(self._spot_overrides.items())))
            n = len(self._spot_overrides)
        self._rebuild()
        if changed:
            self._log.info("updated spot pricing", entries=n)
        return len(prices)

    def _rebuild(self) -> None:
        """Write the overlaid prices back into the lattice tensor in place,
        so every on-device solve (which holds a reference to lattice.price)
        prices with current data; unavailable offerings stay +inf."""
        lat = self.lattice
        with self._lock:
            price = self._static.copy()
            if "on-demand" in lat.capacity_types:
                ci = lat.capacity_types.index("on-demand")
                # the Pricing API reports ONE regional OD price; zonal
                # premiums (local zones) scale it per zone, same as the
                # static lattice build (catalog.od_price)
                zone_scale = np.array(
                    [cat.od_zone_multiplier(z) for z in lat.zones],
                    np.float32)
                for t, p in self._od_overrides.items():
                    ti = lat.name_to_idx.get(t)
                    if ti is not None:
                        price[ti, :, ci] = np.where(
                            lat.available[ti, :, ci], p * zone_scale, np.inf)
            if "spot" in lat.capacity_types:
                ci = lat.capacity_types.index("spot")
                for (t, z), p in self._spot_overrides.items():
                    ti = lat.name_to_idx.get(t)
                    if ti is not None and z in lat.zones:
                        zi = lat.zones.index(z)
                        if lat.available[ti, zi, ci]:
                            price[ti, zi, ci] = p
            lat.price[...] = price
            lat.price_version += 1

    def liveness_ok(self) -> bool:
        return True

    def reset(self) -> None:
        with self._lock:
            self._od_overrides.clear()
            self._spot_overrides.clear()
            self.last_update = None
            # re-arm the log-on-delta gates (under the lock — an in-flight
            # update must not race the swap): post-wipe re-applications
            # are real changes and must leave an audit line
            self._monitor = ChangeMonitor(self.clock)
        self.lattice.price[...] = self._static
        self.lattice.price_version += 1


class PricingController:
    """Singleton 12h refresh loop (reference
    pkg/controllers/pricing/controller.go:42-57). The fake market has no
    live feed, so a refresh re-applies overlays; a real backend plugs its
    fetchers into the two update hooks."""

    def __init__(self, provider: PricingProvider, clock: Optional[Clock] = None):
        self.provider = provider
        self.clock = clock or Clock()
        self._last = 0.0

    def reconcile(self) -> bool:
        now = self.clock.now()
        if now - self._last < PRICING_REFRESH_SECONDS:
            return False
        self._last = now
        self.provider._rebuild()
        return True
