"""Lock/queue contention accounting: instrumented locks for the hot path.

Traces (trace/) explain one request and the sampling profiler
(introspect/profiler.py) attributes CPU time to frames, but neither says
where threads BLOCK — which lock the watch fan-out serializes on, how
long a solve queues behind another caller, whether the ClusterState
mirror is a convoy under API-mode churn. ``InstrumentedLock`` wraps a
``threading.Lock``/``RLock`` with:

- **wait-time accounting** — only a CONTENDED acquire pays any timing:
  the fast path is one non-blocking ``acquire(False)`` plus two
  attribute writes, so an uncontended lock costs near-zero extra and
  records no samples,
- **hold-time accounting** — first-acquire to last-release (re-entrant
  RLock depth tracked), bucketed only when the hold exceeds
  ``HOLD_RECORD_SECONDS`` so steady microsecond holds never churn the
  histogram,
- **owner-at-contention tag** — a blocked waiter resolves the current
  owner's top frame via ``sys._current_frames()`` (only on contention,
  never on the fast path), so "who was holding it" ships with the wait,
- a process-wide **name-keyed registry**: every instance named
  ``"cluster_state"`` aggregates into one ``LockStats`` (tests build
  many Operators; stats must not leak one entry per instance).

Counters are plain int/float attribute updates under the GIL — a rare
lost increment under a true race is acceptable for diagnostics and the
alternative (a meta-lock inside every lock) is not. Everything reports
through ``stats()`` (the introspection registry's ``contention``
provider, flattened numeric keys for the sampler rings), ``detail()``
(the ``/debug/pprof/contention`` document, with owner tags), and the
``karpenter_lock_wait_seconds{lock}`` histogram when a metrics registry
is attached.

``set_enabled(False)`` turns every wrapper into a raw pass-through
(no counters, no clock reads) — the zero-overhead-when-disabled
contract tests/test_profiler.py pins.

**Lock-order witness** (docs/reference/linting.md): every FIRST
acquire also records, per thread, the set of instrumented locks
already held, feeding a process-wide acquisition-order graph — the
edge ``A -> B`` means "some thread held A while acquiring B", with the
acquiring thread's stack captured the first time the edge appears.
Any cycle in that graph is a POTENTIAL DEADLOCK (two threads can
interleave the two orders and wait on each other forever), reported
with every member edge's witness stack via ``lockorder_stats()`` (the
``lockorder`` introspection provider), ``lockorder_detail()``
(``/debug/pprof/lockorder``), and asserted empty as a standing
invariant by the threaded tier-1 tests, ``tools/soak.py``, and the
weather smoke. Edges are keyed by lock NAME (the same aggregation the
wait stats use): two locks sharing a name cannot witness an ordering
between themselves.
"""

from __future__ import annotations

import sys
import threading
import time
import traceback
from typing import Dict, List, Optional, Tuple

# wait/hold bucket upper bounds, SECONDS (percentile estimates mirror
# metrics.Histogram: first bucket whose cumulative count crosses q).
# 50 ms sits between the old 20 ms and 100 ms bounds: scheduler-noise
# tails (a preempted lock holder under CPU saturation) and genuine
# convoy waits straddle exactly that range, and a p99 quantized to one
# shared 100 ms bucket could not rank them (the SOAK_r08 contention
# acceptance needed the resolution).
BUCKETS = (0.00005, 0.0002, 0.001, 0.005, 0.02, 0.05, 0.1, 0.5, 2.0, 10.0)
HOLD_RECORD_SECONDS = 0.0001   # holds under 100 µs: totals only, no bucket
OWNER_TAGS_MAX = 8             # distinct owner-at-contention sites kept

_enabled = True
_reg_lock = threading.Lock()
_registry: Dict[str, "LockStats"] = {}
_metric_hist = None            # karpenter_lock_wait_seconds, when attached

# ---- lock-order witness state ----
_WITNESS_STACK_LIMIT = 18      # frames kept per edge witness
_tls = threading.local()       # .held: this thread's held lock names,
                               # in acquisition order
_order_lock = threading.Lock()
# (held_name, acquired_name) -> {"count": int, "stack": [str, ...]}
_order_edges: Dict[Tuple[str, str], Dict] = {}


def set_enabled(flag: bool) -> None:
    """Process-wide kill switch: False makes every InstrumentedLock a
    raw pass-through (no counters, no perf_counter calls)."""
    global _enabled
    _enabled = bool(flag)


def enabled() -> bool:
    return _enabled


def attach_metrics(histogram) -> None:
    """Attach the ``karpenter_lock_wait_seconds{lock}`` histogram (the
    most recent Operator's registry wins, like the published sampler).
    Observed only on contention — the uncontended path never sees it."""
    global _metric_hist
    _metric_hist = histogram


def reset() -> None:
    """Drop all accumulated stats (test isolation)."""
    with _reg_lock:
        _registry.clear()
    lockorder_reset()


def _stats_for(name: str) -> "LockStats":
    with _reg_lock:
        ls = _registry.get(name)
        if ls is None:
            ls = _registry[name] = LockStats(name)
        return ls


class LockStats:
    """Aggregated accounting for every lock sharing one name."""

    __slots__ = ("name", "acquisitions", "contended", "wait_total_s",
                 "max_wait_s", "wait_buckets", "hold_total_s", "max_hold_s",
                 "hold_buckets", "holds", "owner_tags",
                 "qwaits", "qwait_total_s", "max_qwait_s")

    def __init__(self, name: str):
        self.name = name
        self.acquisitions = 0
        self.contended = 0
        self.wait_total_s = 0.0
        self.max_wait_s = 0.0
        self.wait_buckets = [0] * (len(BUCKETS) + 1)
        self.holds = 0
        self.hold_total_s = 0.0
        self.max_hold_s = 0.0
        self.hold_buckets = [0] * (len(BUCKETS) + 1)
        # owner-site -> times seen at contention (bounded)
        self.owner_tags: Dict[str, int] = {}
        # condition-variable wait (queue wait, e.g. a watcher parked for
        # its next event): kept SEPARATE from lock-wait so idle consumer
        # time never reads as lock contention
        self.qwaits = 0
        self.qwait_total_s = 0.0
        self.max_qwait_s = 0.0

    @staticmethod
    def _bucket_idx(seconds: float) -> int:
        for i, b in enumerate(BUCKETS):
            if seconds <= b:
                return i
        return len(BUCKETS)

    def note_wait(self, seconds: float, owner_tag: Optional[str]) -> None:
        self.contended += 1
        self.wait_total_s += seconds
        if seconds > self.max_wait_s:
            self.max_wait_s = seconds
        self.wait_buckets[self._bucket_idx(seconds)] += 1
        if owner_tag and (owner_tag in self.owner_tags
                          or len(self.owner_tags) < OWNER_TAGS_MAX):
            self.owner_tags[owner_tag] = self.owner_tags.get(owner_tag, 0) + 1
        h = _metric_hist
        if h is not None:
            try:
                h.observe(seconds, lock=self.name)
            except Exception:
                pass   # a torn-down registry must not fail an acquire

    def note_hold(self, seconds: float) -> None:
        self.holds += 1
        self.hold_total_s += seconds
        if seconds > self.max_hold_s:
            self.max_hold_s = seconds
        if seconds >= HOLD_RECORD_SECONDS:
            self.hold_buckets[self._bucket_idx(seconds)] += 1

    def note_qwait(self, seconds: float) -> None:
        self.qwaits += 1
        self.qwait_total_s += seconds
        if seconds > self.max_qwait_s:
            self.max_qwait_s = seconds

    @staticmethod
    def _percentile(buckets: List[int], q: float) -> float:
        total = sum(buckets)
        if total == 0:
            return 0.0
        target = q * total
        cum = 0
        for i, n in enumerate(buckets):
            cum += n
            if cum >= target:
                return BUCKETS[i] if i < len(BUCKETS) else BUCKETS[-1] * 2
        return BUCKETS[-1] * 2

    def wait_p99_s(self) -> float:
        return self._percentile(self.wait_buckets, 0.99)

    def hold_p99_s(self) -> float:
        return self._percentile(self.hold_buckets, 0.99)

    def flat(self) -> Dict[str, float]:
        """Numeric keys for the introspection provider / sampler rings."""
        out = {
            f"{self.name}_acquisitions": self.acquisitions,
            f"{self.name}_contended": self.contended,
            f"{self.name}_wait_total_ms": round(self.wait_total_s * 1e3, 3),
            f"{self.name}_wait_p99_ms": round(self.wait_p99_s() * 1e3, 3),
            f"{self.name}_max_wait_ms": round(self.max_wait_s * 1e3, 3),
            f"{self.name}_max_hold_ms": round(self.max_hold_s * 1e3, 3),
        }
        if self.qwaits:
            out[f"{self.name}_qwait_total_ms"] = round(
                self.qwait_total_s * 1e3, 3)
            out[f"{self.name}_max_qwait_ms"] = round(self.max_qwait_s * 1e3, 3)
        return out

    def doc(self) -> Dict:
        """Full per-lock document (/debug/pprof/contention)."""
        return {
            "acquisitions": self.acquisitions,
            "contended": self.contended,
            "waitTotalMs": round(self.wait_total_s * 1e3, 3),
            "waitP99Ms": round(self.wait_p99_s() * 1e3, 3),
            "maxWaitMs": round(self.max_wait_s * 1e3, 3),
            "holdTotalMs": round(self.hold_total_s * 1e3, 3),
            "holdP99Ms": round(self.hold_p99_s() * 1e3, 3),
            "maxHoldMs": round(self.max_hold_s * 1e3, 3),
            "ownersAtContention": dict(sorted(
                self.owner_tags.items(), key=lambda kv: -kv[1])),
            **({"queueWaits": self.qwaits,
                "queueWaitTotalMs": round(self.qwait_total_s * 1e3, 3),
                "maxQueueWaitMs": round(self.max_qwait_s * 1e3, 3)}
               if self.qwaits else {}),
        }


# ---- lock-order witness ----------------------------------------------------


def _held_list() -> List[str]:
    lst = getattr(_tls, "held", None)
    if lst is None:
        lst = _tls.held = []
    return lst


def _witness_stack() -> List[str]:
    """The acquiring thread's stack as ``file.py:line:func`` frames —
    captured ONCE per distinct edge, never on the steady path."""
    frames = traceback.extract_stack(limit=_WITNESS_STACK_LIMIT + 3)
    out = []
    for fr in frames:
        fname = fr.filename.rsplit("/", 1)[-1]
        if fname == "contention.py":
            continue   # the witness's own frames add no evidence
        out.append(f"{fname}:{fr.lineno}:{fr.name}")
    return out[-_WITNESS_STACK_LIMIT:]


def _note_first_acquire(name: str) -> None:
    """Record ordering edges held->name for every lock this thread
    already holds, then push name onto the thread's held list. Fast
    path per acquire: one thread-local read + a loop over the (almost
    always 0-2 entry) held list + dict membership checks; the stack
    capture and graph lock are paid only the first time an edge is
    seen process-wide."""
    held = _held_list()
    for h in held:
        if h == name:
            continue   # same-name pair (e.g. two per-kind store locks)
        pair = (h, name)
        e = _order_edges.get(pair)
        if e is not None:
            e["count"] += 1    # GIL-atomic enough for diagnostics
            continue
        stack = _witness_stack()
        with _order_lock:
            e = _order_edges.get(pair)
            if e is None:
                _order_edges[pair] = {"count": 1, "stack": stack}
            else:
                e["count"] += 1
    held.append(name)


def _note_last_release(name: str) -> None:
    held = getattr(_tls, "held", None)
    if held:
        # LIFO in the common case; tolerate out-of-order releases (and
        # entries stranded by an enable-toggle mid-hold) by scanning
        for i in range(len(held) - 1, -1, -1):
            if held[i] == name:
                del held[i]
                return


def lockorder_reset() -> None:
    """Drop the acquisition-order graph (test isolation — the
    deliberate lock-inversion test must not poison later no-cycle
    assertions)."""
    with _order_lock:
        _order_edges.clear()


def lockorder_cycles() -> List[List[str]]:
    """Elementary cycles in the acquisition-order graph, each as the
    list of lock names in order (first repeated implicitly). Empty =
    no potential deadlock witnessed. Each cycle is enumerated once,
    anchored at its lexicographically-smallest member."""
    with _order_lock:
        edges = list(_order_edges.keys())
    adj: Dict[str, List[str]] = {}
    for a, b in edges:
        adj.setdefault(a, []).append(b)
    for vs in adj.values():
        vs.sort()
    cycles: List[List[str]] = []
    for start in sorted(adj):
        # DFS restricted to nodes >= start: every elementary cycle is
        # found exactly once, rooted at its smallest node
        path = [start]
        on_path = {start}

        def dfs(node: str) -> None:
            for nxt in adj.get(node, ()):
                if nxt == start:
                    cycles.append(list(path))
                elif nxt > start and nxt not in on_path:
                    path.append(nxt)
                    on_path.add(nxt)
                    dfs(nxt)
                    on_path.discard(nxt)
                    path.pop()

        dfs(start)
    return cycles


def lockorder_stats() -> Dict[str, float]:
    """The ``lockorder`` introspection provider: flat numeric keys for
    the sampler rings and the kpctl top LOCKORDER cell."""
    with _order_lock:
        edges = len(_order_edges)
        acquisitions = sum(e["count"] for e in _order_edges.values())
    return {"edges": float(edges),
            "cycles": float(len(lockorder_cycles())),
            "ordered_acquires": float(acquisitions),
            "enabled": 1.0 if _enabled else 0.0}


def lockorder_detail() -> Dict:
    """The /debug/pprof/lockorder document: the full acquisition-order
    graph with per-edge counts and first-witness stacks, plus every
    cycle with ALL of its member edges' witness stacks — the two (or
    more) code paths that can deadlock each other, named."""
    with _order_lock:
        edges = {f"{a} -> {b}": {"count": e["count"], "stack": e["stack"]}
                 for (a, b), e in sorted(_order_edges.items())}
        raw = dict(_order_edges)
    cycles = []
    for cyc in lockorder_cycles():
        members = []
        for i, a in enumerate(cyc):
            b = cyc[(i + 1) % len(cyc)]
            e = raw.get((a, b), {"count": 0, "stack": []})
            members.append({"edge": f"{a} -> {b}", "count": e["count"],
                            "stack": e["stack"]})
        cycles.append({"locks": cyc, "edges": members})
    return {"enabled": _enabled, "edges": edges, "cycles": cycles}


def _owner_frame_tag(tid: Optional[int]) -> Optional[str]:
    """The owner thread's top frame, ``file.py:func`` — resolved ONLY on
    contention (sys._current_frames walks every thread)."""
    if not tid:
        return None
    try:
        frame = sys._current_frames().get(tid)
        if frame is None:
            return None
        co = frame.f_code
        fname = co.co_filename.rsplit("/", 1)[-1]
        return f"{fname}:{co.co_name}"
    except Exception:
        return None


class InstrumentedLock:
    """A named Lock/RLock wrapper with contention accounting.

    Drop-in for ``with``-style use plus explicit acquire/release and
    ``threading.Condition`` interop (``_is_owned``). Re-entrant iff the
    wrapped lock is an RLock; hold time spans first acquire → matching
    last release."""

    __slots__ = ("_raw", "_stats", "_owner", "_depth", "_t_acq")

    def __init__(self, name: str, raw=None):
        self._raw = raw if raw is not None else threading.Lock()
        self._stats = _stats_for(name)
        self._owner: Optional[int] = None
        self._depth = 0
        self._t_acq = 0.0

    # -- lock protocol --

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if not _enabled:
            return self._raw.acquire(blocking, timeout)
        st = self._stats
        if self._raw.acquire(False):
            ok = True
        elif not blocking:
            return False
        else:
            # contended: the only path that pays timing + owner lookup
            tag = _owner_frame_tag(self._owner)
            t0 = time.perf_counter()
            ok = self._raw.acquire(True, timeout)
            if ok:
                st.note_wait(time.perf_counter() - t0, tag)
        if not ok:
            return False
        # we hold the lock: owner bookkeeping is race-free (re-entrant
        # RLock acquires land here with _owner already == us)
        me = threading.get_ident()
        if self._owner == me:
            self._depth += 1
        else:
            self._owner = me
            self._depth = 1
            self._t_acq = time.perf_counter()
            # lock-order witness: a FIRST acquire while other locks are
            # held records an ordering edge (re-entrant re-acquires are
            # not an ordering event)
            _note_first_acquire(st.name)
        st.acquisitions += 1
        return True

    def release(self) -> None:
        if not _enabled:
            self._raw.release()
            return
        if self._owner == threading.get_ident() and self._depth == 1:
            # last matching release: the hold ends now
            self._stats.note_hold(time.perf_counter() - self._t_acq)
            self._owner = None
            self._depth = 0
            _note_last_release(self._stats.name)
        elif self._depth > 0:
            self._depth -= 1
        self._raw.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def _is_owned(self) -> bool:
        """threading.Condition interop — answer from our owner tracking
        instead of letting Condition probe with acquire(False) (which
        would count phantom acquisitions)."""
        if _enabled:
            return self._owner == threading.get_ident()
        o = getattr(self._raw, "_is_owned", None)
        if o is not None:
            return o()
        if self._raw.acquire(False):
            self._raw.release()
            return False
        return True

    @property
    def stats(self) -> LockStats:
        return self._stats


class InstrumentedCondition(threading.Condition):
    """A Condition over an InstrumentedLock whose ``wait()`` time is
    accounted as QUEUE wait (``qwait`` keys) — time a consumer parked
    for a producer, e.g. a watch subscriber awaiting its next event —
    kept apart from lock-wait so idle parking never reads as lock
    contention."""

    def __init__(self, name: str):
        self._ilock = InstrumentedLock(name)
        super().__init__(lock=self._ilock)

    def wait(self, timeout: Optional[float] = None) -> bool:
        if not _enabled:
            return super().wait(timeout)
        t0 = time.perf_counter()
        try:
            return super().wait(timeout)
        finally:
            self._ilock.stats.note_qwait(time.perf_counter() - t0)


def lock(name: str) -> InstrumentedLock:
    """An instrumented non-reentrant lock."""
    return InstrumentedLock(name, threading.Lock())


def rlock(name: str) -> InstrumentedLock:
    """An instrumented re-entrant lock."""
    return InstrumentedLock(name, threading.RLock())


def condition(name: str) -> InstrumentedCondition:
    return InstrumentedCondition(name)


# ---- reporting -------------------------------------------------------------


def stats() -> Dict[str, float]:
    """The introspection provider: flattened numeric keys per lock
    (``<lock>_wait_p99_ms`` etc. — what `kpctl top`'s CONTENTION row and
    the sampler rings consume)."""
    with _reg_lock:
        entries = sorted(_registry.items())
    out: Dict[str, float] = {"locks": len(entries),
                             "enabled": 1.0 if _enabled else 0.0}
    for _, ls in entries:
        out.update(ls.flat())
    return out


def detail() -> Dict:
    """The /debug/pprof/contention document: per-lock accounting with
    owner-at-contention tags."""
    with _reg_lock:
        entries = sorted(_registry.items())
    return {"enabled": _enabled,
            "locks": {name: ls.doc() for name, ls in entries}}


def top_waits(n: int = 3) -> List[Tuple[str, float, int]]:
    """Top-N locks by wait p99: (name, p99_seconds, contended).
    Bucketed p99s tie often; contended count breaks the tie (at equal
    p99 the lock more threads actually blocked on ranks worse) — the
    ordering is deterministic instead of registry-insertion order."""
    with _reg_lock:
        entries = list(_registry.values())
    ranked = sorted(((ls.name, ls.wait_p99_s(), ls.contended)
                     for ls in entries if ls.contended),
                    key=lambda t: (-t[1], -t[2]))
    return ranked[:n]
