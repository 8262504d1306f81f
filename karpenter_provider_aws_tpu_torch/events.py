"""Event recorder.

Mirror of the reference's k8s event recorder usage (reference
pkg/controllers/interruption/events/events.go, pkg/cloudprovider/events):
controllers publish typed events about API objects; tests and the ops
surface read them back. Host-side, thread-safe, and BOUNDED: a ring
buffer keeps the newest MAX_EVENTS (a real apiserver ages events out the
same way; an append-only list would leak in a long-running controller
whose reconcile loops publish steadily).
"""

from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, List, Optional

MAX_EVENTS = 10_000


@dataclass(frozen=True)
class Event:
    time: float
    type: str          # Normal | Warning
    reason: str
    object_kind: str   # Pod | NodeClaim | Node | NodePool | ...
    object_name: str
    message: str


class Recorder:
    def __init__(self, clock=None):
        from .utils.clock import Clock
        self._clock = clock or Clock()
        self._events: Deque[Event] = deque(maxlen=MAX_EVENTS)
        self._lock = threading.Lock()
        self.published = 0      # lifetime count (the ring forgets; this doesn't)
        self.warnings = 0
        # optional mirror (kube.eventsink.ApiEventSink in API mode):
        # called per event, under the lock, so the mirrored stream keeps
        # publish order. A sink failure must never break the publishing
        # controller — events are observability, not control flow.
        self.sink = None

    def publish(self, type: str, reason: str, object_kind: str, object_name: str,
                message: str) -> None:
        ev = Event(self._clock.now(), type, reason, object_kind, object_name, message)
        with self._lock:
            self._events.append(ev)
            self.published += 1
            if type == "Warning":
                self.warnings += 1
            if self.sink is not None:
                try:
                    self.sink(ev)
                except Exception:
                    pass

    def events(self, reason: Optional[str] = None,
               object_name: Optional[str] = None) -> List[Event]:
        with self._lock:
            out = list(self._events)
        if reason is not None:
            out = [e for e in out if e.reason == reason]
        if object_name is not None:
            out = [e for e in out if e.object_name == object_name]
        return out

    def stats(self) -> dict:
        """Introspection snapshot: ring occupancy + lifetime counters."""
        with self._lock:
            return {"ring": len(self._events), "published": self.published,
                    "warnings": self.warnings}

    def headroom_probe(self) -> dict:
        """Event-ring occupancy (introspect/headroom.py). ``kind="ring"``
        — aging the oldest events out is the retention policy a real
        apiserver applies too, not data loss; "drops" reports how many
        have aged out so the registry's counter parity holds."""
        with self._lock:
            return {"depth": float(len(self._events)),
                    "capacity": float(MAX_EVENTS),
                    "drops": float(max(self.published - len(self._events), 0)),
                    "kind": "ring"}

    def reset(self) -> None:
        with self._lock:
            self._events.clear()
