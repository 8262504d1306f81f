"""Unavailable-offerings (ICE) cache → device availability mask.

Mirror of the reference's ICE feedback loop (reference
pkg/cache/unavailableofferings.go:31-84): CreateFleet insufficient-capacity
errors mark (capacityType, instanceType, zone) unavailable for 3 minutes;
a monotonically increasing sequence number invalidates downstream caches
keyed on the offering set. The TPU-native addition is ``mask(lattice)``:
the cache compiles directly to a boolean [T,Z,C] tensor that is ANDed with
the lattice's market availability before each solve, so ICE'd offerings
vanish from the device kernel's reachability einsum instead of being
re-filtered per pod in a host loop.
"""

from __future__ import annotations

import threading
from typing import Iterable, Optional, Tuple

import numpy as np

from ..errors import Offering, UnfulfillableCapacityError
from ..utils.clock import Clock
from .ttl import TTLCache

UNAVAILABLE_OFFERINGS_TTL = 180.0  # 3 min (reference pkg/cache/cache.go:27-29)


class UnavailableOfferings:
    def __init__(self, clock: Optional[Clock] = None, ttl: float = UNAVAILABLE_OFFERINGS_TTL):
        # expiry bumps seq through the evict hook, whichever path drops
        # the entry — the periodic cleanup() sweep or a lazy delete
        # inside TTLCache.get/__contains__ (is_unavailable between
        # expiry and the next sweep). Version-keyed consumers
        # (masked_view_versioned's memo, the disruption controller's
        # failed-search fingerprints) would otherwise keep a recovered
        # offering off-market until an unrelated mark happened to bump.
        self._cache = TTLCache(ttl, clock, on_evict=lambda _k, _v: self._bump())
        self._seq = 0
        self._lock = threading.Lock()

    def _bump(self) -> None:
        with self._lock:
            self._seq += 1

    @staticmethod
    def _key(capacity_type: str, instance_type: str, zone: str) -> str:
        return f"{capacity_type}:{instance_type}:{zone}"

    @property
    def seq_num(self) -> int:
        with self._lock:
            return self._seq

    def is_unavailable(self, capacity_type: str, instance_type: str, zone: str) -> bool:
        return self._key(capacity_type, instance_type, zone) in self._cache

    def mark_unavailable(self, reason: str, capacity_type: str,
                         instance_type: str, zone: str) -> None:
        self._cache.set(self._key(capacity_type, instance_type, zone), reason)
        with self._lock:
            self._seq += 1

    def mark_unavailable_for_error(self, err: UnfulfillableCapacityError,
                                   reason: str = "InsufficientInstanceCapacity") -> None:
        """Mirror of MarkUnavailableForFleetErr (unavailableofferings.go:55-65)."""
        for capacity_type, instance_type, zone in err.offerings:
            self.mark_unavailable(reason, capacity_type, instance_type, zone)

    def delete(self, capacity_type: str, instance_type: str, zone: str) -> None:
        self._cache.delete(self._key(capacity_type, instance_type, zone))
        with self._lock:
            self._seq += 1

    def flush(self) -> None:
        self._cache.flush()
        with self._lock:
            self._seq += 1

    def cleanup(self) -> int:
        """Expire stale entries. Expiry CHANGES the offering set (capacity is
        back on the market), so it bumps seq_num like marking does —
        downstream fingerprints (e.g. the disruption controller's failed-
        search cache) must invalidate when offerings return. The bump
        itself rides the evict hook (see __init__), once per entry."""
        return self._cache.cleanup()

    def stats(self) -> dict:
        """Introspection snapshot: ICE'd offering count + the sequence
        number downstream version-keyed caches invalidate on."""
        out = self._cache.stats()
        out["seq"] = self.seq_num
        return out

    def entries(self) -> Iterable[Offering]:
        for key, _ in self._cache.items():
            ct, it, z = key.split(":", 2)
            yield (ct, it, z)

    def mask(self, lattice) -> np.ndarray:
        """[T,Z,C] bool: True where the offering is NOT ICE'd. AND with
        ``lattice.available`` before building/solving a problem."""
        return mask_from_entries(lattice, self.entries())


def mask_from_entries(lattice, entries) -> np.ndarray:
    """[T,Z,C] bool mask from (capacity_type, instance_type, zone)
    triples: True where the offering is NOT named. Shared by the ICE
    cache above and the solver sidecar, which receives the operator's
    triples over the Solve RPC and rebuilds the SAME mask against its
    resident lattice (parallel/sidecar.py) — one implementation, so the
    two processes can never disagree on skip-unknown semantics."""
    m = np.ones((lattice.T, lattice.Z, lattice.C), dtype=bool)
    t_idx = lattice.name_to_idx
    z_idx = {z: i for i, z in enumerate(lattice.zones)}
    c_idx = {c: i for i, c in enumerate(lattice.capacity_types)}
    for ct, it, z in entries:
        ti, zi, ci = t_idx.get(it), z_idx.get(z), c_idx.get(ct)
        if ti is not None and zi is not None and ci is not None:
            m[ti, zi, ci] = False
    return m
