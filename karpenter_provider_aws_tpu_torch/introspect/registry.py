"""Provider registry: every stateful subsystem reports cheap stats().

The reference exposes its runtime state through controller-runtime's
/metrics plus ad-hoc pprof/healthz handlers; the gap both it and this
repo had is a LIVE structured view of subsystem state — batcher
occupancy, solve-window coalescing, cache residency, writer throughput,
watch fan-out — without waiting for the next Prometheus scrape or
grepping logs. This registry is that seam: a subsystem registers a
zero-argument ``stats()`` callable returning a flat dict of numbers and
short strings; consumers (the statusz/vars endpoints, the Sampler, the
debug.Monitor soak artifact, ``kpctl top``) fan out over the providers.

Contract (pinned by tests/test_introspect.py):

- ``register()`` is O(1) and replace-by-name: a subsystem rebuilt in the
  same process (tests construct many Operators) replaces its old
  provider instead of leaking it.
- ``collect()`` snapshots the provider list under the registry lock and
  calls every ``stats()`` OUTSIDE it — a provider blocking on its own
  subsystem lock can never wedge registration or other providers'
  collection, and the registry lock is never held across user code.
- a provider that raises reports ``{"error": ...}`` for its name; one
  broken subsystem must not blind the view of the others.
- ``stats()`` implementations must be cheap snapshots (counter reads
  under the subsystem's own lock), never work: the sampler calls every
  provider once per second forever.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List

StatsProvider = Callable[[], Dict]


class IntrospectRegistry:
    def __init__(self):
        self._providers: Dict[str, StatsProvider] = {}
        self._lock = threading.Lock()

    def register(self, name: str, provider: StatsProvider) -> None:
        """Attach (or replace) the provider serving ``name``."""
        with self._lock:
            self._providers[name] = provider

    def unregister(self, name: str) -> None:
        with self._lock:
            self._providers.pop(name, None)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._providers)

    def collect(self) -> Dict[str, Dict]:
        """One stats snapshot per provider, registration-safe: the lock
        guards only the list copy, never the ``stats()`` calls."""
        with self._lock:
            providers = list(self._providers.items())
        out: Dict[str, Dict] = {}
        for name, provider in sorted(providers):
            try:
                stats = provider()
                out[name] = stats if isinstance(stats, dict) else {
                    "value": stats}
            except Exception as e:   # one broken provider never blinds the rest
                out[name] = {"error": f"{type(e).__name__}: {e}"}
        return out
