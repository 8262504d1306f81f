"""Injectable clock (real + fake) for controllers, caches, and batchers.

The reference threads a `clock.Clock` through every controller
(reference cmd/controller/main.go:48) so tests can step time; same here.
"""

from __future__ import annotations

import threading
import time


class Clock:
    """Wall clock."""

    def now(self) -> float:
        return time.time()

    def monotonic(self) -> float:
        return time.monotonic()

    def sleep(self, seconds: float) -> None:
        time.sleep(seconds)


# The shared wall-clock instance for fallback paths: subsystems that
# accept an injected clock but default to wall time (sampler, profiler,
# apiserver) fall back to THIS rather than calling time.time() raw, so
# the clock-discipline lint (tools/lint, docs/reference/linting.md) can
# verify every time read in the package flows through a Clock.
WALL = Clock()


class FakeClock(Clock):
    """Deterministic clock for tests: time moves only via step()."""

    def __init__(self, start: float = 1_000_000.0):
        self._t = start
        self._lock = threading.Lock()

    def now(self) -> float:
        with self._lock:
            return self._t

    def monotonic(self) -> float:
        return self.now()

    def sleep(self, seconds: float) -> None:
        self.step(seconds)

    def step(self, seconds: float) -> None:
        with self._lock:
            self._t += seconds
