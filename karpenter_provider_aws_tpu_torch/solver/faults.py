"""Deterministic fault injection for the solver's device path.

The port of the JAX package's ``solver/faults.py``, verbatim. The cloud
backend already has one-shot error injection (cloud/fake.py
``inject_error``, the reference's AtomicError); this is the same idea
for the SOLVE path, so tests and soaks can force every rung of the
degradation ladder on demand:

- ``g_limit``   — pretend the largest group bucket is this value, so a
  modest batch exercises the wave-split planner exactly as a >4,096-
  group batch would in production.
- ``b_limit``   — cap bin-table growth at this bucket, so the overflow
  retry ladder exhausts and the host-FFD fallback engages.
- ``device_errors`` — raise on the next N device pack calls (the kernel
  launch error / device OOM stand-in); N=1 proves the retry path, a
  larger N proves the fallback.

Attach with ``solver.inject_faults(FaultInjector(...))``; every
injection is counted in ``fired`` so a soak can assert the schedule
actually exercised the path it meant to.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, Optional


@dataclass
class FaultInjector:
    g_limit: Optional[int] = None       # fake ceiling for the group axis
    b_limit: Optional[int] = None       # fake ceiling for the bin table
    device_errors: int = 0              # raise on the next N device calls
    fired: Dict[str, int] = field(default_factory=dict)
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False, compare=False)

    def _count(self, key: str) -> None:
        with self._lock:
            self.fired[key] = self.fired.get(key, 0) + 1

    def take_device_error(self) -> bool:
        """Consume one pending device-error injection (thread-safe)."""
        with self._lock:
            if self.device_errors <= 0:
                return False
            self.device_errors -= 1
            self.fired["device_error"] = self.fired.get("device_error", 0) + 1
            return True

    def note(self, key: str) -> None:
        """Record that an injected ceiling steered the solve (g/b limit)."""
        self._count(key)
