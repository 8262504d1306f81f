"""TTL cache with eviction callbacks.

Mirror of the reference's patrickmn/go-cache usage (reference
pkg/cache/cache.go): per-entry expiry, periodic cleanup, and an on-evict
hook (the launch-template provider GCs stale cloud templates from its
eviction callback, reference pkg/providers/launchtemplate/launchtemplate.go:372-389).
Thread-safe; time injected via Clock for deterministic tests.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

from ..utils.clock import Clock


class TTLCache:
    def __init__(self, ttl: float, clock: Optional[Clock] = None,
                 on_evict: Optional[Callable[[str, Any], None]] = None):
        self.ttl = ttl
        self._clock = clock or Clock()
        self._on_evict = on_evict
        self._data: Dict[str, Tuple[Any, float]] = {}
        self._lock = threading.RLock()

    def get(self, key: str, default: Any = None) -> Any:
        with self._lock:
            entry = self._data.get(key)
            if entry is None:
                return default
            value, expires = entry
            if expires <= self._clock.now():
                del self._data[key]
                evict = self._on_evict
            else:
                return value
        if evict is not None:
            evict(key, value)
        return default

    def __contains__(self, key: str) -> bool:
        sentinel = object()
        return self.get(key, sentinel) is not sentinel

    def set(self, key: str, value: Any, ttl: Optional[float] = None) -> None:
        with self._lock:
            self._data[key] = (value, self._clock.now() + (ttl if ttl is not None else self.ttl))

    def get_or_compute(self, key: str, compute: Callable[[], Any],
                       ttl: Optional[float] = None) -> Any:
        sentinel = object()
        v = self.get(key, sentinel)
        if v is not sentinel:
            return v
        v = compute()
        self.set(key, v, ttl)
        return v

    def delete(self, key: str) -> None:
        with self._lock:
            self._data.pop(key, None)

    def flush(self) -> None:
        with self._lock:
            self._data.clear()

    def cleanup(self) -> int:
        """Drop expired entries (reference runs this on a 10s interval for the
        ICE cache, cache.go:39-42). Returns number evicted."""
        now = self._clock.now()
        evicted = []
        with self._lock:
            for k in list(self._data):
                v, exp = self._data[k]
                if exp <= now:
                    del self._data[k]
                    evicted.append((k, v))
        if self._on_evict is not None:
            for k, v in evicted:
                self._on_evict(k, v)
        return len(evicted)

    def stats(self) -> Dict[str, float]:
        """Introspection snapshot: stored entries (including not-yet-swept
        expired ones — the ``live`` count pays the expiry scan) and the
        configured TTL."""
        now = self._clock.now()
        with self._lock:
            stored = len(self._data)
            live = sum(1 for _, exp in self._data.values() if exp > now)
        return {"entries": stored, "live": live, "ttl_seconds": self.ttl}

    def items(self) -> Iterator[Tuple[str, Any]]:
        now = self._clock.now()
        with self._lock:
            return iter([(k, v) for k, (v, exp) in self._data.items() if exp > now])

    def __len__(self) -> int:
        return sum(1 for _ in self.items())
