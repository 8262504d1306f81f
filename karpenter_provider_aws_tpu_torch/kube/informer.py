"""Reflector/informer: list+watch a kind into a local store with handlers.

The controller-runtime informer analog. A reflector does one initial
``list`` (seeding the store and the sync point), then consumes the watch
stream from the list's resourceVersion, applying ADDED/MODIFIED/DELETED
to the store and invoking the registered handler per event. When the
watch RV falls off the server's history (TooOldError — the 410 Gone), it
RELISTS and reconciles the store against the fresh list, synthesizing
add/update/delete handler calls for the delta — exactly the reflector
recovery path in client-go.

Handlers receive full ENVELOPES ({"metadata": ..., "spec": ...}) — state
appliers need metadata (deletionTimestamp, resourceVersion), not just the
spec.

Two drive modes:

- ``sync_once()`` — pump synchronously: deliver every pending event now.
  The deterministic test/simulation path (FakeClock strata), where the
  caller interleaves pumping and reconciling.
- ``start()/stop()`` — a daemon thread pumping continuously with a
  blocking get. The production path (threaded ControllerRuntime).
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional

from .apiserver import FakeAPIServer, TooOldError, Watch, WatchEvent

# handler(event_type, name, envelope, old_envelope) — envelope is None for
# DELETED, old_envelope is None for ADDED
Handler = Callable[[str, str, Optional[dict], Optional[dict]], None]


class Informer:
    def __init__(self, server: FakeAPIServer, kind: str,
                 handler: Optional[Handler] = None):
        self.server = server
        self.kind = kind
        self.handler = handler
        self.store: Dict[str, dict] = {}    # name -> envelope (local cache)
        self._watch: Optional[Watch] = None
        self._rv = 0
        self._synced = False
        self._lock = threading.RLock()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    @property
    def has_synced(self) -> bool:
        return self._synced

    def specs(self) -> Dict[str, dict]:
        """Snapshot of name -> spec from the local cache."""
        with self._lock:
            return {n: o["spec"] for n, o in self.store.items()}

    # ---- protocol ----------------------------------------------------------

    def _relist(self) -> None:
        """Initial list, or recovery from a 410: replace the store with
        the server's truth, synthesizing handler events for the delta.
        A LOOP, not recursion: under sustained churn (>ring events
        landing between each list and watch attempt) recursion would
        grow the Python stack and eventually kill the informer thread
        instead of retrying like a client-go reflector."""
        while True:
            items, rv = self.server.list(self.kind)
            fresh = {o["metadata"]["name"]: o for o in items}
            with self._lock:
                old = self.store
                self.store = fresh
                self._rv = rv
                self._synced = True
            if self.handler is not None:
                for name, obj in fresh.items():
                    prev = old.get(name)
                    if prev is None:
                        self.handler("ADDED", name, obj, None)
                    elif (prev["metadata"]["resourceVersion"]
                          != obj["metadata"]["resourceVersion"]):
                        self.handler("MODIFIED", name, obj, prev)
                for name, obj in old.items():
                    if name not in fresh:
                        self.handler("DELETED", name, None, obj)
            if self._watch is not None:
                self.server.stop_watch(self._watch)
                self._watch = None
            try:
                self._watch = self.server.watch(self.kind, self._rv)
                return
            except TooOldError:
                # events raced past the ring between our list and watch —
                # relist from the new high-water mark
                continue

    def _apply(self, ev: WatchEvent) -> None:
        if ev.type == "BOOKMARK":
            # no object change — just advance the resume point, so a
            # relist after a 410 starts from a fresh RV (the client-go
            # allowWatchBookmarks contract)
            with self._lock:
                self._rv = ev.resource_version
            return
        name = ev.object["metadata"]["name"]
        with self._lock:
            old = self.store.get(name)
            if ev.type == "DELETED":
                self.store.pop(name, None)
            else:
                self.store[name] = ev.object
            self._rv = ev.resource_version
        if self.handler is not None:
            if ev.type == "DELETED":
                self.handler("DELETED", name, None, old)
            else:
                self.handler(ev.type, name, ev.object, old)

    def sync_once(self) -> int:
        """Deterministic pump: list on first call, then drain every pending
        watch event. Returns the number of events applied. A watcher the
        server dropped for overrunning its bounded queue (TooOldError —
        the in-process 410) recovers by RELISTING, exactly like the
        ring-expiry path."""
        if not self._synced or self._watch is None:
            self._relist()
            return len(self.store)
        try:
            pending = self._watch.pop_pending()
        except TooOldError:
            self._synced = False
            self._relist()
            return len(self.store)
        n = 0
        for ev in pending:
            self._apply(ev)
            n += 1
        return n

    # ---- threaded mode -----------------------------------------------------

    def _run(self) -> None:
        while not self._stop.is_set():
            if not self._synced or self._watch is None:
                self._relist()
            try:
                ev = self._watch.get(timeout=0.2)
            except TooOldError:
                # overran the bounded per-watcher queue: relist on the
                # next loop turn (_relist unsubscribes the dead watch)
                self._synced = False
                continue
            if ev is not None:
                self._apply(ev)

    def start(self) -> "Informer":
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name=f"informer-{self.kind}", daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: float = 2.0) -> None:
        self._stop.set()
        if self._watch is not None:
            self._watch.stop()
        if self._thread is not None:
            self._thread.join(timeout)


class InformerSet:
    """The shared-informer-factory analog: one informer per kind, pumped
    or started together, in a FIXED kind order for the deterministic path
    (config kinds before pods before nodes/claims, so appliers observe
    referents first on initial sync)."""

    def __init__(self, server: FakeAPIServer):
        self.server = server
        self.informers: Dict[str, Informer] = {}
        self._order: List[str] = []

    def add(self, kind: str, handler: Optional[Handler] = None) -> Informer:
        inf = Informer(self.server, kind, handler)
        self.informers[kind] = inf
        self._order.append(kind)
        return inf

    def sync_once(self) -> int:
        return sum(self.informers[k].sync_once() for k in self._order)

    def start(self) -> "InformerSet":
        for k in self._order:
            self.informers[k].start()
        return self

    def stop(self) -> None:
        for k in self._order:
            self.informers[k].stop()

    @property
    def has_synced(self) -> bool:
        return all(i.has_synced for i in self.informers.values())
