"""Generic request coalescer.

Mirror of the reference's hash-bucketed batcher (reference
pkg/batcher/batcher.go:61-131): concurrent callers Add() individual
requests; a worker collects them until an idle window elapses with no new
arrivals, a max window elapses, or the batch hits max_items, then executes
one fused call and fans results back out. The reference coalesces
CreateFleet at 35 ms idle / 1 s max / 1000 items
(createfleet.go:70-72) and DescribeInstances at 100 ms / 1 s / 500
(describeinstances.go:185-187); this framework reuses the same windows for
the fake-cloud launch/terminate paths AND as the device-batch admission
window in front of Solve() (SURVEY.md §2.3).

Requests are bucketed by an options hash so only like-for-like requests
fuse (the reference hashes everything but the instance-id list).
"""

from __future__ import annotations

import threading
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Callable, Dict, Generic, Hashable, List, Sequence, Tuple, TypeVar

from .. import trace
from ..utils.clock import Clock, WALL

T = TypeVar("T")  # request
U = TypeVar("U")  # response


@dataclass
class BatcherOptions:
    idle_seconds: float = 0.035   # CreateFleet window (createfleet.go:70)
    max_seconds: float = 1.0
    max_items: int = 1000


class _Bucket(Generic[T, U]):
    """One hash bucket with a PERSISTENT worker thread.

    A drained worker parks on the wakeup event with NO timeout — an idle
    bucket costs zero periodic wakeups (the previous design timed out
    every idle window regardless). The max-window clock (``started_at``)
    starts at the batch's FIRST ARRIVAL (set by ``add`` when pending goes
    empty → non-empty), not at batch execution, so the max_seconds bound
    is measured from when the oldest caller started waiting."""

    def __init__(self, opts: BatcherOptions,
                 batch_fn: Callable[[List[T]], Sequence[U]],
                 clock: Clock = None):
        self.opts = opts
        self.batch_fn = batch_fn
        # the max-window clock reads the INJECTED clock (FakeClock in the
        # deterministic stratum; the shared wall instance otherwise) —
        # the idle-window park below stays a real Event wait either way
        self._clock = clock if clock is not None else WALL
        # (request, future, producer traceparent-or-None): the producer's
        # trace context rides the queue so the drain — which runs on the
        # bucket's own worker thread, outside any caller's contextvars —
        # can LINK its fused-call span back to every caller it served
        self.pending: List[Tuple[T, Future, object]] = []
        self.wakeup = threading.Event()
        # instrumented (introspect/contention.py): producer-vs-drain
        # contention on the bucket queue
        from ..introspect import contention
        self.lock = contention.lock("batcher_bucket")
        self.thread: threading.Thread = None
        self.started_at: float = 0.0
        # occupancy counters (introspect/ providers read these through
        # Batcher.stats(); mutated only under self.lock)
        self.batches = 0        # drains executed
        self.items = 0          # requests served
        self.max_batch = 0      # largest single drain

    def add(self, request: T, fut: Future) -> None:
        ctx = trace.capture()
        with self.lock:
            if not self.pending:
                # first arrival of this batch arms the max-window clock
                self.started_at = self._clock.monotonic()
            self.pending.append((request, fut, ctx))
            start = self.thread is None
            if start:
                self.thread = threading.Thread(target=self.run, daemon=True)
        self.wakeup.set()
        if start:
            self.thread.start()

    def run(self):
        while True:
            # drained: park with no timeout until the next arrival
            self.wakeup.wait()
            while True:
                self.wakeup.clear()
                with self.lock:
                    if not self.pending:
                        break   # back to the park
                    time_left = self.opts.max_seconds - (
                        self._clock.monotonic() - self.started_at)
                    full = len(self.pending) >= self.opts.max_items
                if not full and time_left > 0:
                    fired = self.wakeup.wait(
                        timeout=min(self.opts.idle_seconds, time_left))
                    if fired:
                        # new arrival inside the idle window: keep
                        # coalescing (until the max window closes)
                        continue
                with self.lock:
                    batch, self.pending = self.pending, []
                    if batch:
                        self.batches += 1
                        self.items += len(batch)
                        self.max_batch = max(self.max_batch, len(batch))
                if batch:
                    try:
                        self._execute(batch)
                    except BaseException as e:
                        # the worker is PERSISTENT now — a crash here
                        # would orphan this bucket's future arrivals, so
                        # fail this batch's callers and keep running
                        for _, fut, _ctx in batch:
                            if not fut.done():
                                fut.set_exception(e)

    def _execute(self, batch: List[Tuple[T, Future, object]]):
        inputs = [b[0] for b in batch]
        # the drain's span is a fresh root on the worker thread, LINKED to
        # every producer that contributed a request — the flight-recorder
        # view of "these N callers shared one fused call"
        links = [c for _, _, c in batch if c]
        # a single-caller drain JOINS its caller's trace; a fused drain is
        # its own root linked to every producer (a span cannot have N
        # parents — links are the standard answer)
        parent = links[0] if len(links) == 1 else None
        try:
            # materialize before the length check: a generator-returning
            # batch_fn must fail its callers, not kill the worker
            with trace.span("batch.drain", parent=parent,
                            links=links if len(links) > 1 else (),
                            n=len(batch), coalesced=len(batch) > 1):
                results = list(self.batch_fn(inputs))
            if len(results) != len(batch):
                raise RuntimeError(
                    f"batch_fn returned {len(results)} results "
                    f"for {len(batch)} requests")
        except BaseException as e:  # fan the failure out to every caller
            for _, fut, _ctx in batch:
                fut.set_exception(e)
            return
        for (_, fut, _ctx), res in zip(batch, results):
            if isinstance(res, BaseException):
                fut.set_exception(res)
            else:
                fut.set_result(res)


class Batcher(Generic[T, U]):
    """``batch_fn(requests) -> responses`` (positionally aligned; a response
    may be an exception instance to fail just that caller)."""

    def __init__(self, batch_fn: Callable[[List[T]], Sequence[U]],
                 options: BatcherOptions = None,
                 hasher: Callable[[T], Hashable] = None,
                 clock: Clock = None):
        self.batch_fn = batch_fn
        self.opts = options or BatcherOptions()
        self.hasher = hasher or (lambda _req: 0)
        self._clock = clock
        self._buckets: Dict[Hashable, _Bucket] = {}
        self._lock = threading.Lock()

    def add(self, request: T, timeout: float = 30.0) -> U:
        """Block until the fused call completes; return this request's result."""
        fut: Future = Future()
        key = self.hasher(request)
        with self._lock:
            bucket = self._buckets.get(key)
            if bucket is None:
                bucket = _Bucket(self.opts, self.batch_fn, self._clock)
                self._buckets[key] = bucket
        bucket.add(request, fut)
        return fut.result(timeout=timeout)

    def stats(self) -> Dict[str, int]:
        """Occupancy snapshot for the introspection registry: bucket
        count, queued depth, drain counters. Cheap — per-bucket counter
        reads under each bucket's own lock, never blocking a drain."""
        with self._lock:
            buckets = list(self._buckets.values())
        pending = batches = items = 0
        max_batch = 0
        for b in buckets:
            with b.lock:
                pending += len(b.pending)
                batches += b.batches
                items += b.items
                max_batch = max(max_batch, b.max_batch)
        return {"buckets": len(buckets), "pending": pending,
                "batches": batches, "items": items, "max_batch": max_batch}

    def headroom_probe(self) -> Dict[str, float]:
        """Deepest bucket vs the max_items drain trigger
        (introspect/headroom.py). ``kind="ring"`` in the registry's
        sense — hitting max_items forces an immediate drain (the bound
        is a flush trigger, not a loss edge), so full is by design."""
        with self._lock:
            buckets = list(self._buckets.values())
        deepest = 0
        for b in buckets:
            with b.lock:
                if len(b.pending) > deepest:
                    deepest = len(b.pending)
        return {"depth": float(deepest),
                "capacity": float(self.opts.max_items),
                "kind": "ring"}
