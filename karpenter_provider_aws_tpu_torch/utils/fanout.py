"""Bounded parallel fan-out — the workqueue.ParallelizeUntil analog.

The reference fans interruption messages 10-way
(pkg/controllers/interruption/controller.go:104) and garbage-collection
existence checks 100-way
(pkg/controllers/nodeclaim/garbagecollection/controller.go:78). Host-side
work here is I/O-shaped (cloud API calls), so threads are the right
primitive; device work never goes through this path.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional, Sequence, TypeVar

T = TypeVar("T")
R = TypeVar("R")


def parallelize(workers: int, items: Sequence[T], fn: Callable[[T], R],
                pool: Optional[ThreadPoolExecutor] = None) -> List[R]:
    """Apply ``fn`` to every item with at most ``workers`` concurrent
    calls; results keep item order. Exceptions propagate after all
    submitted work drains (first one wins), matching ParallelizeUntil's
    fail-late behavior for a finite work list.

    Pass a persistent ``pool`` (see :class:`LazyPool`) from per-pass
    callers — spinning up a fresh executor every reconcile tick costs more
    than the fan-out saves against fast backends."""
    if not items:
        return []
    if workers <= 1 or len(items) == 1:
        return [fn(i) for i in items]
    if pool is not None:
        return list(pool.map(fn, items))
    with ThreadPoolExecutor(max_workers=min(workers, len(items))) as ex:
        return list(ex.map(fn, items))


class LazyPool:
    """A lazily-created, reused ThreadPoolExecutor for a controller's
    per-reconcile fan-out (the reference's workqueue holds its goroutine
    pool for the controller's lifetime the same way)."""

    def __init__(self, workers: int, name: str = "fanout"):
        self.workers = workers
        self.name = name
        self._pool: Optional[ThreadPoolExecutor] = None
        self._lock = threading.Lock()

    def get(self) -> ThreadPoolExecutor:
        with self._lock:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=self.workers,
                    thread_name_prefix=self.name)
            return self._pool

    def run(self, items: Sequence[T], fn: Callable[[T], R]) -> List[R]:
        if not items or len(items) == 1:
            return [fn(i) for i in items]
        return parallelize(self.workers, items, fn, pool=self.get())
