"""Sampler: bounded ring time-series over the provider registry.

One daemon thread (or on-demand ``sample_once()`` in the deterministic
stratum) collects every provider's stats on an interval and appends the
NUMERIC keys into a bounded per-provider ring. The rings are what
``/debug/vars?series=1`` serves and what the soak harness's Monitor
persists — per-subsystem series instead of ad-hoc counters.

Everything is bounded and off the hot path: subsystems never see the
sampler (they only expose ``stats()``), the rings are fixed-depth
deques, and a sampling failure is recorded, never raised.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

from ..utils.clock import WALL
from .registry import IntrospectRegistry

DEFAULT_RING = 600   # 10 min of 1 Hz samples per provider


class Sampler:
    def __init__(self, registry: IntrospectRegistry, ring: int = DEFAULT_RING,
                 clock=None):
        self.registry = registry
        self.ring = max(int(ring), 2)
        self._clock = clock          # None = wall clock (threaded strata)
        # provider -> deque[(t, {numeric stats})]; created lazily so a
        # provider registered mid-run starts recording at its next sample
        self._rings: Dict[str, Deque[Tuple[float, Dict[str, float]]]] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.samples_taken = 0
        self.started_at = self._now()

    def _now(self) -> float:
        return (self._clock.now() if self._clock is not None
                else WALL.now())

    # ---- sampling ---------------------------------------------------------

    def sample_once(self) -> Dict[str, Dict]:
        """Collect one snapshot and append its numeric keys to the rings.
        Returns the full (numeric + string) snapshot."""
        t = self._now()
        snap = self.registry.collect()
        with self._lock:
            for name, stats in snap.items():
                nums = {k: float(v) for k, v in stats.items()
                        if isinstance(v, (int, float))
                        and not isinstance(v, bool)}
                ring = self._rings.get(name)
                if ring is None:
                    ring = self._rings[name] = deque(maxlen=self.ring)
                ring.append((t, nums))
            self.samples_taken += 1
        return snap

    def start(self, interval: float = 1.0) -> "Sampler":
        if self._thread is not None and self._thread.is_alive():
            return self

        def run():
            while not self._stop.is_set():
                try:
                    self.sample_once()
                except Exception:
                    pass   # the sampler must never die mid-soak
                self._stop.wait(interval)
        self._stop.clear()
        self._thread = threading.Thread(target=run, name="introspect-sampler",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(2.0)
            self._thread = None

    def headroom_probe(self) -> Dict[str, float]:
        """Ring occupancy (introspect/headroom.py): the FULLEST
        per-provider ring vs the shared depth. ``kind="ring"`` — a full
        ring is 10 minutes of history, exactly as designed."""
        with self._lock:
            fullest = max((len(r) for r in self._rings.values()), default=0)
        return {"depth": float(fullest), "capacity": float(self.ring),
                "kind": "ring"}

    # ---- series export ----------------------------------------------------

    def series(self) -> Dict[str, Dict]:
        """Columnar per-provider series: ``{provider: {"t": [...],
        "series": {key: [...]}}}``. A key absent from an early sample
        (counter added mid-run) backfills 0.0 so columns stay aligned."""
        with self._lock:
            rings = {name: list(ring) for name, ring in self._rings.items()}
        out: Dict[str, Dict] = {}
        for name, points in rings.items():
            keys: List[str] = sorted({k for _, nums in points for k in nums})
            out[name] = {
                "t": [round(t, 3) for t, _ in points],
                "series": {k: [nums.get(k, 0.0) for _, nums in points]
                           for k in keys},
            }
        return out
