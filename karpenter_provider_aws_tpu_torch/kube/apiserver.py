"""In-memory Kubernetes-API-shaped object store: list/watch/create/update/
patch/delete over versioned wire objects.

This is the ingest boundary of the framework — the analog of the apiserver
the reference's controllers are wired against (reference
cmd/controller/main.go:47-53 builds core controllers over a client +
cluster state; pkg/operator/operator.go:92-186 builds the manager and its
field indexers; pkg/test/environment.go:83-162 drives the same protocol
from envtest in unit tests). Everything that crosses this seam is a plain
JSON-able dict in the apis/serde wire format wrapped in a k8s-style
envelope::

    {"kind": "Pod",
     "metadata": {"name", "uid", "resourceVersion", "creationTimestamp",
                  "deletionTimestamp", "finalizers"},
     "spec": <serde dict>}

Semantics mirrored from the real protocol:

- **resourceVersion**: one global monotonic counter; every write stamps
  the object and the emitted watch event. ``update`` requires the caller's
  metadata.resourceVersion to match the stored one (409 Conflict
  otherwise) — optimistic concurrency, exactly the reference's
  client-side retry contract.
- **watch**: per-kind subscriptions deliver ADDED/MODIFIED/DELETED events
  in RV order. Each kind keeps a bounded event history; a watch resuming
  from an RV older than the history raises ``TooOldError`` (the HTTP 410
  Gone that forces a reflector relist). Per-watcher queues are BOUNDED:
  a subscriber that overruns ``watch_queue_bound`` is dropped to the same
  410/relist path instead of growing an unbounded deque, and periodic
  BOOKMARK events carry the current RV so an idle watcher's resume point
  stays fresh (the real apiserver's allowWatchBookmarks contract).
- **finalizers**: ``delete`` on an object with finalizers only stamps
  deletionTimestamp (MODIFIED event); the object is removed when an
  update clears the last finalizer while deletionTimestamp is set — the
  reference's NodeClaim termination flow runs on exactly this contract.
- **subresources**: pods/binding (``bind``) and pods/eviction (``evict``,
  PDB-enforced server-side like the real Eviction API).
- **field indexers**: ``add_index``/``get_by_index`` mirror the manager's
  NodeClaim provider-id index (operator.go:180-186). Indexes are REAL
  inverted maps maintained on every write — a lookup touches only the
  matching names, never the whole store.
- **admission**: pluggable per-kind hooks run on create/update — the
  webhook seam (reference pkg/webhooks/webhooks.go) so invalid objects
  are rejected AT the boundary, not after ingestion.

Write-path scaling (the 100k-pod-churn design; docs/reference/watch.md):

- **Frozen envelopes, copy-on-read.** Every stored envelope is FROZEN at
  write time (``FrozenDict``/``FrozenList`` — dict/list subclasses whose
  mutators raise, so ``json.dumps`` still sees plain containers). Reads
  (``get``/``list``/``get_by_index``), watch delivery, and history replay
  all hand out the SAME shared object with zero copying; a consumer that
  needs a private mutable copy calls ``copy.deepcopy`` (deepcopy thaws).
  The isolation the old per-watcher deepcopy bought is now structural: a
  handler cannot corrupt siblings or history because it cannot mutate the
  envelope at all.
- **Per-kind store locks + lock-free RV allocation.** Each kind has its
  own re-entrant store lock (all registered under the ``api_server``
  contention name, so accounting aggregates); pods churn never convoys
  nodeclaim writes. RVs come from one atomic counter with per-kind
  high-water marks published under the kind lock — monotonic per kind
  without any cross-kind serialization. Nested cross-kind acquisition
  (evict's PDB read) always follows KINDS order.
- **Fan-out outside the lock.** ``_emit`` only appends the shared event
  to the history ring and a per-kind publish queue; the actual delivery
  to subscriber queues runs AFTER the store lock is released, under a
  per-kind combining flush — a slow watcher can never convoy writers,
  and per-kind RV delivery order is preserved (watcher queues dedup by
  RV, so a subscription replay racing the flusher stays exactly-once).
- **Batched writes.** ``bulk()`` applies many creates/patches/binds/
  evictions/deletes with ONE lock acquisition, one admission sweep, and
  one delivery flush per kind touched — per-object events and RVs, batch
  cost amortized (kube/writer.py ApiWriter routes a provisioning pass's
  pod binds and a drain's evictions through it).
"""

from __future__ import annotations

import copy
import gc as _gc
import itertools
import threading
from collections import deque
from dataclasses import dataclass
from typing import (Callable, Dict, List, Optional, Sequence, Set, Tuple,
                    Union)

from ..utils.clock import WALL

# kinds are plural lowercase, like REST resource paths
KINDS = ("pods", "nodes", "nodeclaims", "nodepools", "nodeclasses",
         "pvcs", "storageclasses", "pdbs", "leases", "events")

EVENT_HISTORY = 4096      # per-kind watch event ring; older RVs are "410 Gone"
WATCH_QUEUE_BOUND = 8192  # per-watcher queue bound; overrun -> 410/relist
BOOKMARK_EVERY = 256      # deliveries between per-watcher BOOKMARK events
BULK_CHUNK = 16           # max ops applied per bulk lock acquisition: a
                          # hold spans ~0.15 ms of interpreter time, so
                          # the window in which an OS-preempted holder
                          # can park waiters stays minimal — bulk wait
                          # tails then reflect handoff, not preemption
                          # luck (lock overhead per op is ~µs; the
                          # delivery flush still amortizes whole-batch)


class APIError(Exception):
    """Base of every apiserver error."""


class NotFoundError(APIError):
    pass


class AlreadyExistsError(APIError):
    pass


class ConflictError(APIError):
    """Stale resourceVersion on update (HTTP 409)."""


class TooOldError(APIError):
    """Watch RV fell off the event history, or a watcher overran its
    bounded queue (HTTP 410 Gone) — relist."""


class InvalidObjectError(APIError):
    """Admission rejected the object (HTTP 422); .causes lists reasons."""

    def __init__(self, kind: str, name: str, causes: Sequence[str]):
        super().__init__(f"{kind}/{name} rejected: " + "; ".join(causes))
        self.causes = list(causes)


class EvictionBlockedError(APIError):
    """A PodDisruptionBudget currently permits no eviction (HTTP 429)."""


# ---- frozen wire containers -------------------------------------------------


def _frozen_mutate(self, *a, **k):
    raise TypeError(
        "apiserver envelopes are frozen shared objects; copy.deepcopy() "
        "one to get a private mutable copy (deepcopy thaws)")


class FrozenDict(dict):
    """A read-only dict: every mutator raises. Still a ``dict`` subclass,
    so ``json.dumps`` and ``isinstance(..., dict)`` consumers see a plain
    mapping. ``copy.deepcopy`` THAWS — it returns an ordinary mutable
    deep copy — so the standard get→deepcopy→mutate→update flow works."""

    __slots__ = ()

    __setitem__ = _frozen_mutate
    __delitem__ = _frozen_mutate
    __ior__ = _frozen_mutate
    clear = _frozen_mutate
    pop = _frozen_mutate
    popitem = _frozen_mutate
    setdefault = _frozen_mutate
    update = _frozen_mutate

    def __deepcopy__(self, memo):
        return {k: copy.deepcopy(v, memo) for k, v in self.items()}

    def __reduce__(self):   # pickle as a plain dict
        return (dict, (dict(self),))


class FrozenList(list):
    """Read-only list counterpart of FrozenDict (same thaw-on-deepcopy
    contract). Concatenation with a plain list yields a plain list, so
    read-modify patterns like ``taints + [new]`` keep working."""

    __slots__ = ()

    __setitem__ = _frozen_mutate
    __delitem__ = _frozen_mutate
    __iadd__ = _frozen_mutate
    __imul__ = _frozen_mutate
    append = _frozen_mutate
    extend = _frozen_mutate
    insert = _frozen_mutate
    pop = _frozen_mutate
    remove = _frozen_mutate
    clear = _frozen_mutate
    sort = _frozen_mutate
    reverse = _frozen_mutate

    def __deepcopy__(self, memo):
        return [copy.deepcopy(v, memo) for v in self]

    def __reduce__(self):   # pickle as a plain list
        return (list, (list(self),))


def freeze(obj):
    """Recursively wrap dicts/lists in their frozen counterparts. The
    one canonical copy per RV every reader and watcher shares. Already-
    frozen subtrees SHORT-CIRCUIT: successive revisions of an object
    structurally share their unchanged immutable subtrees, so freezing
    a patched envelope walks only the changed spine, not the object."""
    t = type(obj)
    if t is FrozenDict or t is FrozenList:
        return obj   # canonical already — the whole subtree is immutable
    if isinstance(obj, dict):
        return FrozenDict((k, freeze(v)) for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        return FrozenList(freeze(v) for v in obj)
    return obj


def thaw(obj):
    """A private mutable deep copy of a (possibly frozen) envelope."""
    return copy.deepcopy(obj)


@dataclass
class WatchEvent:
    type: str          # ADDED | MODIFIED | DELETED | BOOKMARK
    kind: str
    object: dict       # the SHARED frozen envelope (immutable)
    resource_version: int


class Watch:
    """One watch subscription: a BOUNDED FIFO the server appends to.

    ``pop_pending()`` drains without blocking (the deterministic pump);
    ``get(timeout)`` blocks (the threaded reflector). ``stop()`` wakes
    blocked readers with a ``None`` sentinel. A subscriber that overruns
    ``bound`` queued events is dropped: its queue clears and every later
    read raises ``TooOldError`` — the informer relists, exactly like a
    410 on the wire. Duplicate deliveries (a subscription replay racing
    the fan-out flusher) are deduped by RV, which per-kind delivery
    order makes safe."""

    def __init__(self, kind: str, bound: int = WATCH_QUEUE_BOUND,
                 on_drop=None):
        self.kind = kind
        self.bound = bound
        self._on_drop = on_drop   # server-level cumulative drop counter
        self._events: deque = deque()
        # instrumented (introspect/contention.py): lock-wait on the
        # condition is fan-out contention; wait() time is accounted
        # separately as QUEUE wait (a parked watcher is not contention)
        from ..introspect import contention
        self._cond = contention.condition("watch_event")
        self._stopped = False
        self._overflowed = False
        self._last_rv = 0          # highest object RV pushed (dedup floor)
        self._since_bookmark = 0
        self.drops = 0             # events discarded at overflow
        self.bookmarks = 0
        self.max_depth = 0         # deepest this queue ever got (monotonic)

    def _push(self, ev: WatchEvent, replay: bool = False) -> bool:
        """Append the SHARED event object (no copy). Returns True when it
        was queued; False for duplicates, overflow, or a stopped watch.
        ``replay`` (subscription-time history hand-over) is exempt from
        the bound: the client asked for exactly that backlog and has not
        yet had a chance to consume — only live streaming can overrun."""
        with self._cond:
            if self._stopped or self._overflowed:
                return False
            if ev.type != "BOOKMARK" and ev.resource_version <= self._last_rv:
                return False   # replay/fan-out duplicate (dedup by RV)
            if not replay and len(self._events) >= self.bound:
                # overrun: drop this watcher to 410/relist instead of
                # growing without bound — thousands of slow watchers
                # must not amplify every MODIFIED into unbounded memory
                n = len(self._events) + 1
                self.drops += n
                self._events.clear()
                self._overflowed = True
                self._cond.notify_all()
                if self._on_drop is not None:
                    # the hub's cumulative counter: a dropped watcher
                    # unsubscribing must not erase the evidence
                    self._on_drop(n)
                return False
            self._events.append(ev)
            if len(self._events) > self.max_depth:
                self.max_depth = len(self._events)
            if ev.type != "BOOKMARK":
                self._last_rv = ev.resource_version
                self._since_bookmark += 1
            self._cond.notify_all()
            return True

    def _maybe_bookmark(self, every: int) -> bool:
        """Queue a BOOKMARK carrying the current RV once ``every`` real
        events have been delivered since the last one (fan-out flusher
        only). Keeps a resuming watcher's RV fresh without a relist."""
        with self._cond:
            if (self._stopped or self._overflowed or every <= 0
                    or self._since_bookmark < every):
                return False
            self._since_bookmark = 0
            self._events.append(WatchEvent(
                type="BOOKMARK", kind=self.kind,
                object=freeze({"kind": self.kind,
                               "metadata": {"resourceVersion": self._last_rv}}),
                resource_version=self._last_rv))
            if len(self._events) > self.max_depth:
                self.max_depth = len(self._events)
            self.bookmarks += 1
            self._cond.notify_all()
            return True

    def depth(self) -> int:
        """Queued (undelivered) events, read under the watch's own
        condition — the locked accessor stats() uses."""
        with self._cond:
            return len(self._events)

    def _check_overflow(self) -> None:
        if self._overflowed:
            raise TooOldError(
                f"{self.kind}: watcher overran its {self.bound}-event "
                f"queue bound; relist")

    def pop_pending(self) -> List[WatchEvent]:
        with self._cond:
            self._check_overflow()
            out = list(self._events)
            self._events.clear()
            return out

    def get(self, timeout: Optional[float] = None) -> Optional[WatchEvent]:
        with self._cond:
            self._check_overflow()
            if not self._events and not self._stopped:
                self._cond.wait(timeout)
                self._check_overflow()
            if self._events:
                return self._events.popleft()
            return None

    def stop(self) -> None:
        with self._cond:
            self._stopped = True
            self._cond.notify_all()


class _DeferGC:
    """Defer automatic garbage collection across a critical section.

    A gen-2 collection landing while a store lock is held convoys every
    writer of that kind — and with JAX's gc callback installed a full
    collection costs hundreds of ms (the soak's owner-at-contention tags
    caught ``_xla_gc_callback`` holding the api_server lock for >1 s).
    Depth-counted and process-wide: collection is re-enabled (and runs,
    if due) at the outermost exit, so the pause lands OUTSIDE the lock.
    A no-op when the embedding process already disabled gc itself."""

    _lock = threading.Lock()
    _depth = 0
    _we_disabled = False

    def __enter__(self):
        cls = _DeferGC
        with cls._lock:
            if cls._depth == 0 and _gc.isenabled():
                _gc.disable()
                cls._we_disabled = True
            cls._depth += 1
        return self

    def __exit__(self, *exc):
        cls = _DeferGC
        with cls._lock:
            cls._depth -= 1
            if cls._depth == 0 and cls._we_disabled:
                cls._we_disabled = False
                _gc.enable()
        return False


# one bulk operation: ("create", kind, spec[, finalizers]) |
# ("update", kind, envelope) | ("patch", kind, name, spec_patch[, status,
# finalizers]) | ("bind", pod, node) | ("evict", pod[, force]) |
# ("delete", kind, name[, force])
BulkOp = Tuple


class FakeAPIServer:
    def __init__(self, clock=None, watch_queue_bound: int = WATCH_QUEUE_BOUND,
                 bookmark_every: int = BOOKMARK_EVERY):
        """``clock`` (utils.clock.Clock-like) stamps server-side times —
        deletionTimestamp on finalizer-gated deletes, like the real
        apiserver stamps deletion times itself. Defaults to wall clock."""
        self._clock = clock
        self.watch_queue_bound = watch_queue_bound
        self.bookmark_every = bookmark_every
        # per-kind store locks (introspect/contention.py): ALL registered
        # under the one "api_server" name so contention accounting
        # aggregates across the decomposition — `kpctl top` CONTENTION
        # still reports the hub as one lock, now without the old
        # every-verb convoy
        from ..introspect import contention
        self._locks = {k: contention.rlock("api_server") for k in KINDS}
        # lock-free RV allocator: next() on itertools.count is atomic
        # under the GIL; per-kind high-water marks publish under the
        # kind lock (monotonic per kind — the watch contract's unit)
        self._rv = itertools.count(1)
        self._kind_rv: Dict[str, int] = {k: 0 for k in KINDS}
        self._store: Dict[str, Dict[str, dict]] = {k: {} for k in KINDS}
        self._history: Dict[str, deque] = {
            k: deque(maxlen=EVENT_HISTORY) for k in KINDS}
        self._watches: Dict[str, List[Watch]] = {k: [] for k in KINDS}
        # fan-out outside the store lock: writers append events here
        # (under the kind lock), then one combining flusher per kind
        # delivers to subscriber queues with no store lock held
        self._pub: Dict[str, deque] = {k: deque() for k in KINDS}
        self._pub_mutex: Dict[str, threading.Lock] = {
            k: threading.Lock() for k in KINDS}
        self._deliver = {k: contention.lock("api_fanout") for k in KINDS}
        # field indexes: key_fn registry + REAL inverted maps
        # ((kind, index) -> value -> {names}; name -> value for removal)
        self._indexes: Dict[Tuple[str, str], Callable[[dict], Optional[str]]] = {}
        self._index_maps: Dict[Tuple[str, str], Dict[str, Set[str]]] = {}
        self._index_keys: Dict[Tuple[str, str], Dict[str, str]] = {}
        self._kind_indexes: Dict[str, List[str]] = {}
        self._admission: Dict[str, List[Callable[[dict], List[str]]]] = {}
        self._defaulters: Dict[str, List[Callable[[dict], dict]]] = {}
        self._uid = itertools.count(1)
        # per-kind fan-out counters, each written ONLY by that kind's
        # (single, combining) flusher — cross-kind flushes never race a
        # shared "+=" (a lost increment would silently undercount the
        # karpenter_api_* series); the totals are summed properties
        self._kind_delivered: Dict[str, int] = {k: 0 for k in KINDS}
        self._kind_bookmarks: Dict[str, int] = {k: 0 for k in KINDS}
        self._kind_drops: Dict[str, int] = {k: 0 for k in KINDS}
        self._bulk_count_lock = threading.Lock()
        self.bulk_calls = 0
        self.bulk_ops = 0
        # per-watcher envelope copies made on the fan-out path. The new
        # delivery design shares ONE frozen object, so this stays 0 by
        # construction — the bench writepath row records it as the
        # no-copy pin (a reintroduced copy must increment it)
        self.fanout_envelope_copies = 0
        # process-monotonic watch-queue high water: folded from each
        # watch's own max_depth when it unsubscribes, so stats() never
        # regresses when a deep (or dropped) watcher goes away — the
        # headroom registry's monotonic-high-water contract
        self._watch_hw = 0
        # the PDB math's namespace index (policy/v1 allowance is computed
        # over one namespace's pods, never a full-store scan)
        self.add_index("pods", "namespace",
                       lambda spec: spec.get("namespace", "default"))

    @property
    def events_emitted(self) -> int:
        """Watch fan-out deliveries pushed, total (sum of the per-kind
        flusher counters)."""
        return sum(self._kind_delivered.values())

    @property
    def bookmarks_sent(self) -> int:
        return sum(self._kind_bookmarks.values())

    @property
    def watch_drops(self) -> int:
        """Cumulative events discarded dropping overrun watchers —
        survives the dropped watcher's unsubscribe/relist."""
        return sum(self._kind_drops.values())

    @property
    def last_rv(self) -> int:
        """Global high-water RV: max over the per-kind marks (each is
        only advanced under its kind's lock, so this never regresses)."""
        return max(self._kind_rv.values())

    def stats(self) -> Dict[str, int]:
        """Introspection snapshot of the watch hub: subscriber fan-out,
        queued (undelivered) events via the LOCKED per-watch depth
        accessor, store occupancy, write sequence, bulk/bookmark/drop
        counters. Takes no store lock — a stats poll can never convoy a
        writer."""
        watchers = 0
        queued = 0
        # seeded from the unsubscribe fold: watch_max_depth is monotonic
        # per process, not "max over watchers that happen to be alive"
        max_depth = self._watch_hw
        deepest = 0
        for ws in self._watches.values():
            for w in tuple(ws):
                watchers += 1
                d = w.depth()
                queued += d
                if d > deepest:
                    deepest = d
                if w.max_depth > max_depth:
                    max_depth = w.max_depth
        objects = sum(len(s) for s in self._store.values())
        return {"watchers": watchers, "watch_queue_depth": queued,
                "watch_deepest": deepest,
                "watch_max_depth": max_depth,
                "watch_drops": self.watch_drops,
                "bookmarks": self.bookmarks_sent,
                "objects": objects, "events_emitted": self.events_emitted,
                "bulk_calls": self.bulk_calls, "bulk_ops": self.bulk_ops,
                "fanout_envelope_copies": self.fanout_envelope_copies,
                "last_rv": self.last_rv}

    # ---- headroom probes (introspect/headroom.py) --------------------------

    def headroom_probe(self) -> Dict[str, float]:
        """Per-watcher queue saturation: depth = the DEEPEST live queue
        (first watcher to hit the bound 410s regardless of the others),
        capacity = the shared bound, drops/high-water = the cumulative
        hub counters that survive a dropped watcher's unsubscribe."""
        deepest = 0
        hw = self._watch_hw
        for ws in self._watches.values():
            for w in tuple(ws):
                d = w.depth()
                if d > deepest:
                    deepest = d
                if w.max_depth > hw:
                    hw = w.max_depth
        return {"depth": float(deepest),
                "capacity": float(self.watch_queue_bound),
                "highwater": float(hw),
                "drops": float(self.watch_drops)}

    def headroom_probe_publish(self) -> Dict[str, float]:
        """Fan-out publish backlog: events appended by writers but not
        yet delivered by the combining flushers. Unbounded (capacity 0)
        — the forecast watches the fill rate, not an occupancy."""
        return {"depth": float(sum(len(q) for q in self._pub.values())),
                "capacity": 0.0}

    # ---- admission (webhook seam) -----------------------------------------

    def register_admission(self, kind: str,
                           validate: Optional[Callable[[dict], List[str]]] = None,
                           default: Optional[Callable[[dict], dict]] = None) -> None:
        """Install a validating and/or defaulting hook for a kind. The
        validator sees the SPEC wire dict and returns error strings
        (empty = admitted); the defaulter returns the (possibly mutated)
        spec. Mirrors the reference's knative-style admission chain."""
        if validate is not None:
            self._admission.setdefault(kind, []).append(validate)
        if default is not None:
            self._defaulters.setdefault(kind, []).append(default)

    def _admit(self, kind: str, name: str, spec: dict) -> dict:
        for d in self._defaulters.get(kind, ()):
            try:
                spec = d(spec)
            except InvalidObjectError:
                raise   # a defaulter's own precise rejection passes through
            except Exception as e:
                # a defaulter crashing on input the schema would have
                # rejected must still surface as an admission rejection
                # (callers only handle InvalidObjectError); the message
                # class distinguishes defaulter bugs from bad input
                raise InvalidObjectError(
                    kind, name, [f"defaulting failed: {e}"])
        causes: List[str] = []
        for v in self._admission.get(kind, ()):
            causes.extend(v(spec))
        if causes:
            raise InvalidObjectError(kind, name, causes)
        return spec

    # ---- store + index maintenance (caller holds the kind lock) -----------

    def _check_kind(self, kind: str) -> None:
        if kind not in self._store:
            raise APIError(f"unknown kind {kind!r}")

    def _index_put(self, kind: str, name: str, spec: dict) -> None:
        for idx in self._kind_indexes.get(kind, ()):
            key_fn = self._indexes[(kind, idx)]
            keys = self._index_keys[(kind, idx)]
            fwd = self._index_maps[(kind, idx)]
            try:
                new = key_fn(spec)
            except Exception:
                new = None   # a broken key_fn must not fail the write
            old = keys.get(name)
            if old == new:
                continue
            if old is not None:
                bucket = fwd.get(old)
                if bucket is not None:
                    bucket.discard(name)
                    if not bucket:
                        del fwd[old]
            if new is not None:
                fwd.setdefault(new, set()).add(name)
                keys[name] = new
            else:
                keys.pop(name, None)

    def _index_del(self, kind: str, name: str) -> None:
        for idx in self._kind_indexes.get(kind, ()):
            keys = self._index_keys[(kind, idx)]
            old = keys.pop(name, None)
            if old is not None:
                fwd = self._index_maps[(kind, idx)]
                bucket = fwd.get(old)
                if bucket is not None:
                    bucket.discard(name)
                    if not bucket:
                        del fwd[old]

    def _store_put(self, kind: str, name: str, obj: dict) -> None:
        self._store[kind][name] = obj
        self._index_put(kind, name, obj["spec"])

    def _store_del(self, kind: str, name: str) -> None:
        del self._store[kind][name]
        self._index_del(kind, name)

    @staticmethod
    def _spine(cur: dict) -> dict:
        """Mutable SHALLOW working copy of a frozen envelope: plain
        top-level/metadata/spec dicts whose values still reference the
        shared immutable subtrees. Because nothing frozen is ever
        mutated in place, revisions may structurally share unchanged
        children — a patch pays O(changed spine), not O(object), inside
        the store lock (thaw() stays for callers that need a fully
        private copy)."""
        return {"kind": cur["kind"],
                "metadata": dict(cur["metadata"]),
                "spec": dict(cur["spec"]),
                "status": cur.get("status") or {}}

    # ---- watch fan-out (publish queue + combining flusher) ----------------

    def _emit(self, type_: str, kind: str, obj: dict) -> None:
        """Record the event (caller holds the kind lock): ONE shared
        frozen event object goes to the history ring and the publish
        queue. No subscriber work happens here — delivery runs in
        ``_flush`` after the store lock is released."""
        ev = WatchEvent(type=type_, kind=kind, object=obj,
                        resource_version=obj["metadata"]["resourceVersion"])
        self._history[kind].append(ev)
        self._pub[kind].append(ev)

    def _flush(self, kind: str) -> None:
        """Deliver queued events to every subscriber, OUTSIDE the store
        lock. A combining flush: one thread drains at a time (per-kind
        delivery stays in RV order); a writer that loses the non-blocking
        acquire returns immediately — the active flusher re-checks the
        queue after releasing, so no event is stranded."""
        pub = self._pub[kind]
        mtx = self._pub_mutex[kind]
        dlv = self._deliver[kind]
        while True:
            if not pub:
                return
            if not dlv.acquire(blocking=False):
                return   # active flusher will observe our events
            try:
                while True:
                    with mtx:
                        if not pub:
                            break
                        # drain by popleft, NEVER list()+clear(): writers
                        # append under the STORE lock (not this mutex),
                        # so an append landing between a snapshot and a
                        # clear would be discarded undelivered — a lost
                        # DELETE the mirror never heals from (the
                        # SOAK_r08 agreement check caught exactly this)
                        batch = []
                        while pub:
                            batch.append(pub.popleft())
                        watchers = tuple(self._watches[kind])
                    delivered = 0
                    for ev in batch:
                        for w in watchers:
                            if w._push(ev):
                                delivered += 1
                    self._kind_delivered[kind] += delivered
                    if self.bookmark_every > 0:
                        for w in watchers:
                            if w._maybe_bookmark(self.bookmark_every):
                                self._kind_bookmarks[kind] += 1
            finally:
                dlv.release()
            # closing the missed-wakeup window: an append that raced our
            # release is drained by looping (its own flush attempt may
            # have lost the non-blocking acquire to us)
            with mtx:
                if not pub:
                    return

    def _next_rv(self, kind: str) -> int:
        rv = next(self._rv)         # lock-free allocation
        self._kind_rv[kind] = rv    # published under the kind lock
        return rv

    # ---- core verbs --------------------------------------------------------
    # Every public verb is: kind lock -> _<verb>_locked -> flush. The
    # _locked internals are shared with bulk(), which holds each kind's
    # lock ONCE for a whole batch.

    def create(self, kind: str, spec: dict, *,
               finalizers: Sequence[str] = ()) -> dict:
        """Create an object from its serde spec; returns the (frozen)
        envelope — deepcopy it for a mutable private copy. Admission and
        the envelope build run BEFORE the store lock (_prebuild): a slow
        validator (jsonschema on nodeclaims/nodepools) must never hold
        the kind's writers up."""
        self._check_kind(kind)
        env = self._prebuild(kind, spec, finalizers)
        with _DeferGC(), self._locks[kind]:
            obj = self._create_locked(kind, env)
        self._flush(kind)
        return obj

    def _prebuild(self, kind: str, spec: dict,
                  finalizers: Sequence[str] = ()) -> dict:
        """Admission + the whole envelope build, OUTSIDE any store lock:
        returns a plain-spine envelope (frozen leaves) with a
        placeholder RV. ``_create_locked`` stamps the real RV and
        installs it — the locked phase of a create is dup-check + RV +
        store/index put + emit, nothing O(object)."""
        name = spec.get("name")
        if not name:
            raise APIError(f"{kind}: spec has no name")
        spec = freeze(self._admit(kind, name, thaw(spec)))
        return {
            "kind": kind,
            "metadata": {
                "name": name,
                "uid": f"uid-{next(self._uid):06d}",
                "resourceVersion": 0,   # stamped under the kind lock
                # stamped when a clock is wired (live mode); None in
                # clock-free tests, where RV orders events
                "creationTimestamp": (self._clock.now()
                                      if self._clock else None),
                "deletionTimestamp": None,
                "finalizers": list(finalizers),
            },
            "spec": spec,
            # controller-owned status sub-map (the k8s spec/status
            # split): written only via patch(status_patch=...), and
            # PRESERVED across user spec updates — `kpctl get -o yaml
            # | kpctl apply` can never re-submit stale status
            "status": {},
        }

    def _create_locked(self, kind: str, env: dict) -> dict:
        """Install a ``_prebuild`` envelope (caller holds the kind
        lock): dup-check, stamp the RV, store, emit."""
        name = env["metadata"]["name"]
        if name in self._store[kind]:
            raise AlreadyExistsError(f"{kind}/{name} already exists")
        env["metadata"]["resourceVersion"] = self._next_rv(kind)
        obj = freeze(env)   # spine walk only: the leaves froze outside
        self._store_put(kind, name, obj)
        self._emit("ADDED", kind, obj)
        return obj

    def get(self, kind: str, name: str) -> dict:
        """Returns the FROZEN stored envelope (zero-copy shared read);
        ``copy.deepcopy`` it before mutating (deepcopy thaws)."""
        self._check_kind(kind)
        with self._locks[kind]:
            obj = self._store[kind].get(name)
            if obj is None:
                raise NotFoundError(f"{kind}/{name} not found")
            return obj

    def now(self) -> float:
        """The server's clock reading — the timebase every timestamp the
        server stamps (creationTimestamp, deletionTimestamp, event times)
        lives on. Clients rendering ages must anchor to THIS, not their
        own wall clock: under a FakeClock (or plain clock skew) the two
        can differ arbitrarily."""
        return (self._clock.now() if self._clock is not None
                else WALL.now())

    def list(self, kind: str) -> Tuple[List[dict], int]:
        """Returns (items, listResourceVersion) — watch from the returned
        RV to observe every later change exactly once. Items are the
        frozen stored envelopes (no per-item copies: the old O(store)
        deepcopy per list is gone)."""
        self._check_kind(kind)
        with self._locks[kind]:
            return list(self._store[kind].values()), self.last_rv

    def update(self, kind: str, obj: dict) -> dict:
        """Full-object update with optimistic concurrency: the caller's
        metadata.resourceVersion must match the stored object's. The
        envelope's ``status`` sub-map is controller-owned and EXCLUDED
        from the write — the stored status survives a user apply
        verbatim (spec/status split; write status via
        ``patch(status_patch=...)``). Admission runs BEFORE the store
        lock — the caller's spec does not depend on stored state."""
        self._check_kind(kind)
        name = obj["metadata"]["name"]
        spec = freeze(self._admit(kind, name, thaw(obj["spec"])))
        with _DeferGC(), self._locks[kind]:
            new = self._update_locked(kind, obj, pre_spec=spec)
        self._flush(kind)
        return new

    def _update_locked(self, kind: str, obj: dict,
                       pre_spec: Optional[dict] = None) -> dict:
        name = obj["metadata"]["name"]
        cur = self._store[kind].get(name)
        if cur is None:
            raise NotFoundError(f"{kind}/{name} not found")
        if obj["metadata"]["resourceVersion"] != cur["metadata"]["resourceVersion"]:
            raise ConflictError(
                f"{kind}/{name}: stale resourceVersion "
                f"{obj['metadata']['resourceVersion']} "
                f"(current {cur['metadata']['resourceVersion']})")
        spec = (pre_spec if pre_spec is not None
                else self._admit(kind, name, thaw(obj["spec"])))
        new = self._spine(cur)
        new["spec"] = spec
        new["metadata"]["finalizers"] = list(obj["metadata"].get("finalizers", ()))
        new["metadata"]["resourceVersion"] = self._next_rv(kind)
        new = freeze(new)
        # clearing the last finalizer of a deleting object removes it
        if (new["metadata"]["deletionTimestamp"] is not None
                and not new["metadata"]["finalizers"]):
            self._store_del(kind, name)
            self._emit("DELETED", kind, new)
        else:
            self._store_put(kind, name, new)
            self._emit("MODIFIED", kind, new)
        return new

    @staticmethod
    def _merge_value(target: dict, k: str, v) -> None:
        """RFC 7386 JSON merge patch for one key: ``None`` deletes, maps
        merge RECURSIVELY (so writers of disjoint annotation/label keys
        never clobber each other's entries), everything else replaces."""
        if v is None:
            target.pop(k, None)
        elif isinstance(v, dict):
            # RFC 7386 §2: a non-object (or missing) target counts as {},
            # so deletion markers inside the patch vanish instead of
            # being stored verbatim as None values — status patches skip
            # admission and would otherwise persist them
            base = target.get(k)
            sub = dict(base) if isinstance(base, dict) else {}
            for sk, sv in v.items():
                FakeAPIServer._merge_value(sub, sk, sv)
            target[k] = sub
        else:
            target[k] = copy.deepcopy(v)

    def patch(self, kind: str, name: str, spec_patch: Optional[dict] = None, *,
              status_patch: Optional[dict] = None,
              finalizers: Optional[Sequence[str]] = None) -> dict:
        """JSON-merge-patch on the spec (RFC 7386: ``None`` values delete
        keys, nested maps merge per-key), the controller-owned envelope
        ``status`` sub-map, and/or replace the finalizer list. No RV
        precondition — a patch applies to whatever is current, like a
        server-side strategic merge. Status patches skip spec admission:
        they never contain user intent.

        For kinds WITH admission hooks (nodeclaims, nodepools, ...), the
        merged spec is validated OPTIMISTICALLY outside the store lock:
        snapshot the current spec+RV, merge+admit unlocked, then apply
        under the lock only if the RV is still current — a racing writer
        re-runs the merge (bounded retries, falling back to the locked
        path). A nodeclaim status write's jsonschema pass must never
        hold up the kind's other writers."""
        self._check_kind(kind)
        if spec_patch and (self._admission.get(kind)
                           or self._defaulters.get(kind)):
            for _ in range(4):
                with self._locks[kind]:
                    cur = self._store[kind].get(name)
                    if cur is None:
                        raise NotFoundError(f"{kind}/{name} not found")
                    base_rv = cur["metadata"]["resourceVersion"]
                    base_spec = cur["spec"]
                merged = dict(base_spec)
                for k, v in spec_patch.items():
                    self._merge_value(merged, k, v)
                admitted = freeze(self._admit(kind, name, merged))
                with _DeferGC(), self._locks[kind]:
                    cur = self._store[kind].get(name)
                    if cur is None:
                        raise NotFoundError(f"{kind}/{name} not found")
                    if cur["metadata"]["resourceVersion"] != base_rv:
                        continue   # racing writer landed: re-merge
                    new = self._patch_locked(
                        kind, name, None, status_patch=status_patch,
                        finalizers=finalizers, pre_spec=admitted)
                self._flush(kind)
                return new
            # contended object: give up optimism, admit under the lock
        with _DeferGC(), self._locks[kind]:
            new = self._patch_locked(kind, name, spec_patch,
                                     status_patch=status_patch,
                                     finalizers=finalizers)
        self._flush(kind)
        return new

    def _patch_locked(self, kind: str, name: str,
                      spec_patch: Optional[dict] = None, *,
                      status_patch: Optional[dict] = None,
                      finalizers: Optional[Sequence[str]] = None,
                      pre_spec: Optional[dict] = None) -> dict:
        cur = self._store[kind].get(name)
        if cur is None:
            raise NotFoundError(f"{kind}/{name} not found")
        # structural sharing: only the changed spine is copied inside
        # the lock (_merge_value's recursion already builds fresh
        # sub-dicts for the keys it touches; untouched subtrees stay
        # the shared frozen objects)
        new = self._spine(cur)
        if pre_spec is not None:
            # merged + admitted outside the lock (the public patch
            # verb's optimistic path); the caller proved the base RV is
            # still current before handing it in
            new["spec"] = pre_spec
        elif spec_patch:
            for k, v in spec_patch.items():
                self._merge_value(new["spec"], k, v)
            new["spec"] = self._admit(kind, name, new["spec"])
        if status_patch:
            status = dict(new["status"])
            for k, v in status_patch.items():
                self._merge_value(status, k, v)
            new["status"] = status
        if finalizers is not None:
            new["metadata"]["finalizers"] = list(finalizers)
        new["metadata"]["resourceVersion"] = self._next_rv(kind)
        new = freeze(new)
        if (new["metadata"]["deletionTimestamp"] is not None
                and not new["metadata"]["finalizers"]):
            self._store_del(kind, name)
            self._emit("DELETED", kind, new)
        else:
            self._store_put(kind, name, new)
            self._emit("MODIFIED", kind, new)
        return new

    def delete(self, kind: str, name: str, *, now: Optional[float] = None,
               force: bool = False) -> None:
        """Delete an object. With finalizers present (and not ``force``),
        only stamps deletionTimestamp — the finalizing controller removes
        the object later by clearing the finalizer list."""
        self._check_kind(kind)
        with _DeferGC(), self._locks[kind]:
            self._delete_locked(kind, name, now=now, force=force)
        self._flush(kind)

    def _delete_locked(self, kind: str, name: str, *,
                       now: Optional[float] = None,
                       force: bool = False) -> None:
        cur = self._store[kind].get(name)
        if cur is None:
            raise NotFoundError(f"{kind}/{name} not found")
        if cur["metadata"]["finalizers"] and not force:
            if cur["metadata"]["deletionTimestamp"] is None:
                new = self._spine(cur)
                # the server stamps deletion time itself when the
                # caller didn't; never 0.0/falsy — every downstream
                # consumer truth-tests deletion_timestamp
                if now is None:
                    now = (self._clock.now() if self._clock is not None
                           else WALL.now())
                new["metadata"]["deletionTimestamp"] = now or 1e-9
                new["metadata"]["resourceVersion"] = self._next_rv(kind)
                new = freeze(new)
                self._store_put(kind, name, new)
                self._emit("MODIFIED", kind, new)
            return
        gone = self._spine(cur)
        gone["metadata"]["resourceVersion"] = self._next_rv(kind)
        gone = freeze(gone)
        self._store_del(kind, name)
        self._emit("DELETED", kind, gone)

    # ---- batched apply -----------------------------------------------------

    def bulk(self, ops: Sequence[BulkOp]) -> List[Union[dict, None, APIError]]:
        """Apply many write operations with one out-of-lock admission
        sweep (creates and updates — a patch's merged spec depends on
        stored state, so hook-bearing kinds admit patches under the
        lock here; use the single ``patch`` verb for its optimistic
        out-of-lock validation when that matters), bounded amortized
        lock holds (≤ ``BULK_CHUNK`` ops per acquisition — a
        thousand-pod wave never pins a kind's other writers for the
        whole batch), and one delivery flush per kind touched — the
        write-coalescing verb (kube/writer.py ApiWriter batches a
        provisioning pass's binds and a drain's evictions through it).

        Op shapes (tuples)::

            ("create", kind, spec[, finalizers])
            ("update", kind, envelope)
            ("patch",  kind, name, spec_patch[, status_patch, finalizers])
            ("bind",   pod_name, node_name)
            ("evict",  pod_name[, force])
            ("delete", kind, name[, force])

        Ops GROUP BY KIND (bind/evict are pods): relative order within a
        kind is preserved — the per-kind linearizability unit — while
        cross-kind order inside one bulk is unspecified. Per-op failures
        are CAPTURED: the result list aligns with ``ops`` and holds the
        envelope (None for delete) or the APIError instance, so one
        conflict never aborts the rest of the batch."""
        results: List[Union[dict, None, APIError]] = [None] * len(ops)
        by_kind: Dict[str, List[int]] = {}
        prepared: Dict[int, dict] = {}
        for i, op in enumerate(ops):
            verb = op[0]
            kind = "pods" if verb in ("bind", "evict") else op[1]
            self._check_kind(kind)
            if verb == "create":
                # the admission sweep + whole envelope build run HERE,
                # outside any store lock — the locked phase of a bulk
                # create is dup-check + RV stamp + store put + emit
                try:
                    prepared[i] = self._prebuild(
                        kind, op[2], op[3] if len(op) > 3 else ())
                except APIError as e:
                    results[i] = e
                    continue
            elif verb == "update":
                # an update's spec does not depend on stored state:
                # admit it out of the lock like the single verb does
                try:
                    prepared[i] = freeze(self._admit(
                        kind, op[2]["metadata"]["name"],
                        thaw(op[2]["spec"])))
                except APIError as e:
                    results[i] = e
                    continue
            by_kind.setdefault(kind, []).append(i)
        with self._bulk_count_lock:
            self.bulk_calls += 1
            self.bulk_ops += len(ops)
        for kind, idxs in by_kind.items():
            # bounded lock holds: at most BULK_CHUNK ops per acquisition
            # (a thousand-pod wave must not pin the kind's other writers
            # for the whole batch), gc deferred for each held span so a
            # due collection runs after release instead of inside it.
            # Per-kind op order is preserved across chunks; ONE delivery
            # flush still covers the whole batch.
            for lo in range(0, len(idxs), BULK_CHUNK):
                chunk = idxs[lo:lo + BULK_CHUNK]
                with _DeferGC(), self._locks[kind]:
                    self._bulk_apply_locked(ops, chunk, prepared, results)
            self._flush(kind)
        return results

    def _bulk_apply_locked(self, ops, idxs, prepared, results) -> None:
        for i in idxs:
            op = ops[i]
            verb = op[0]
            try:
                if verb == "create":
                    results[i] = self._create_locked(op[1], prepared[i])
                elif verb == "update":
                    results[i] = self._update_locked(
                        op[1], op[2], pre_spec=prepared[i])
                elif verb == "patch":
                    results[i] = self._patch_locked(
                        op[1], op[2], op[3],
                        status_patch=op[4] if len(op) > 4 else None,
                        finalizers=op[5] if len(op) > 5 else None)
                elif verb == "bind":
                    results[i] = self._bind_locked(op[1], op[2])
                elif verb == "evict":
                    results[i] = self._evict_locked(
                        op[1], force=bool(op[2]) if len(op) > 2
                        else False)
                elif verb == "delete":
                    self._delete_locked(
                        op[1], op[2],
                        force=bool(op[3]) if len(op) > 3 else False)
                    results[i] = None
                else:
                    raise APIError(f"unknown bulk verb {verb!r}")
            except APIError as e:
                results[i] = e

    # ---- watch -------------------------------------------------------------

    def watch(self, kind: str, resource_version: int = 0) -> Watch:
        """Subscribe from ``resource_version`` (exclusive). Events already
        past that RV replay from the history ring (the SAME shared event
        objects — replay copies nothing); an RV older than the ring
        raises TooOldError (relist, like a 410 Gone)."""
        self._check_kind(kind)
        with self._locks[kind]:
            hist = self._history[kind]
            # a full ring has dropped events (all with RV < hist[0]'s);
            # resuming below that horizon can't replay them — 410 Gone.
            # A non-full ring still holds the kind's entire lifetime, so
            # any RV (including 0) is safe.
            if (len(hist) == hist.maxlen
                    and resource_version < hist[0].resource_version - 1):
                raise TooOldError(
                    f"{kind}: watch from rv={resource_version} too old "
                    f"(history starts at {hist[0].resource_version})")
            def _note_drop(n: int, _k: str = kind) -> None:
                # called from the kind's single flusher thread only
                self._kind_drops[_k] += n

            w = Watch(kind, bound=self.watch_queue_bound,
                      on_drop=_note_drop)
            for ev in hist:
                if ev.resource_version > resource_version:
                    # shared frozen event — zero-copy replay, exempt from
                    # the bound (the caller asked for this backlog)
                    w._push(ev, replay=True)
            with self._pub_mutex[kind]:
                self._watches[kind].append(w)
            return w

    def stop_watch(self, w: Watch) -> None:
        with self._pub_mutex[w.kind]:
            if w in self._watches[w.kind]:
                self._watches[w.kind].remove(w)
            if w.max_depth > self._watch_hw:
                self._watch_hw = w.max_depth
        w.stop()

    # ---- subresources ------------------------------------------------------

    def bind(self, pod_name: str, node_name: str) -> dict:
        """pods/binding: set spec.nodeName on an unbound pod."""
        with _DeferGC(), self._locks["pods"]:
            out = self._bind_locked(pod_name, node_name)
        self._flush("pods")
        return out

    def _bind_locked(self, pod_name: str, node_name: str) -> dict:
        cur = self._store["pods"].get(pod_name)
        if cur is None:
            raise NotFoundError(f"pods/{pod_name} not found")
        if cur["spec"].get("nodeName"):
            raise ConflictError(
                f"pod {pod_name} already bound to {cur['spec']['nodeName']}")
        return self._patch_locked("pods", pod_name, {"nodeName": node_name})

    def _pdb_allowance(self, pdb_spec: dict) -> int:
        """Server-side disruptions-allowed math (policy/v1): healthy =
        bound matching pods without deletionTimestamp. Caller holds the
        pods lock. Matching pods come from the NAMESPACE inverted index
        — allowance is O(pods in the namespace), so an ApiWriter drain
        is no longer O(total pods) per eviction."""
        sel = pdb_spec.get("labelSelector", {})
        ns = pdb_spec.get("namespace", "default")
        ns_names = self._index_maps[("pods", "namespace")].get(ns, ())
        store = self._store["pods"]
        matching = []
        for name in ns_names:
            obj = store[name]
            s = obj["spec"]
            if s.get("isDaemonset"):
                continue
            if all(s.get("labels", {}).get(k) == v for k, v in sel.items()):
                matching.append(obj)
        healthy = sum(1 for o in matching
                      if o["spec"].get("nodeName")
                      and o["metadata"]["deletionTimestamp"] is None
                      # pods carry deletion state in SPEC too (our pods
                      # have no finalizers, so a draining pod is marked
                      # at the spec level — state/cluster.py:204 uses the
                      # same representation for healthy math)
                      and o["spec"].get("deletionTimestamp") is None)
        allowed = len(matching)
        if pdb_spec.get("minAvailable") is not None:
            allowed = min(allowed, healthy - int(pdb_spec["minAvailable"]))
        if pdb_spec.get("maxUnavailable") is not None:
            unavailable = len(matching) - healthy
            allowed = min(allowed, int(pdb_spec["maxUnavailable"]) - unavailable)
        return max(allowed, 0)

    def evict(self, pod_name: str, *, force: bool = False) -> dict:
        """pods/eviction: unbind the pod (the workload controller instantly
        re-creates it pending in this simulation, so eviction == unbind).
        PDBs are enforced HERE, server-side, exactly like the real
        Eviction API; ``force`` models a grace-zero pod delete that
        bypasses budgets (the reference's force-drain backstop)."""
        with _DeferGC(), self._locks["pods"]:
            out = self._evict_locked(pod_name, force=force)
        self._flush("pods")
        return out

    def _evict_locked(self, pod_name: str, *, force: bool = False) -> dict:
        cur = self._store["pods"].get(pod_name)
        if cur is None:
            raise NotFoundError(f"pods/{pod_name} not found")
        spec = cur["spec"]
        if not force and not spec.get("isDaemonset"):
            # nested cross-kind read follows KINDS order (pods < pdbs),
            # so it can never deadlock against bulk (one kind at a time)
            with self._locks["pdbs"]:
                pdbs = list(self._store["pdbs"].values())
            for pdb in pdbs:
                ps = pdb["spec"]
                sel = ps.get("labelSelector", {})
                if ps.get("namespace", "default") != spec.get("namespace", "default"):
                    continue
                if not all(spec.get("labels", {}).get(k) == v
                           for k, v in sel.items()):
                    continue
                if self._pdb_allowance(ps) <= 0:
                    raise EvictionBlockedError(
                        f"pod {pod_name}: PDB {pdb['metadata']['name']} "
                        f"permits no eviction now")
        return self._patch_locked("pods", pod_name, {"nodeName": None})

    # ---- field indexers ----------------------------------------------------

    def add_index(self, kind: str, index: str,
                  key_fn: Callable[[dict], Optional[str]]) -> None:
        """Register a field index over SPEC dicts (the manager's
        FieldIndexer analog, operator.go:180-186). Builds a REAL inverted
        map, maintained on every create/update/patch/delete — lookups
        never scan the store."""
        self._check_kind(kind)
        with self._locks[kind]:
            fresh = (kind, index) not in self._indexes
            self._indexes[(kind, index)] = key_fn
            if fresh:
                self._kind_indexes.setdefault(kind, []).append(index)
            fwd: Dict[str, Set[str]] = {}
            keys: Dict[str, str] = {}
            self._index_maps[(kind, index)] = fwd
            self._index_keys[(kind, index)] = keys
            for name, obj in self._store[kind].items():
                try:
                    key = key_fn(obj["spec"])
                except Exception:
                    key = None
                if key is not None:
                    fwd.setdefault(key, set()).add(name)
                    keys[name] = key

    def get_by_index(self, kind: str, index: str, value: str) -> List[dict]:
        """Indexed lookup via the inverted map: touches ONLY matching
        objects. Returns frozen stored envelopes (the copy-on-read
        discipline every read verb follows)."""
        key_fn = self._indexes.get((kind, index))
        if key_fn is None:
            raise APIError(f"no index {index!r} on {kind}")
        with self._locks[kind]:
            names = self._index_maps[(kind, index)].get(value, ())
            store = self._store[kind]
            return [store[n] for n in sorted(names)]
