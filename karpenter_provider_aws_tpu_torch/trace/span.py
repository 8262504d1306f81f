"""Zero-dependency request-scoped tracing: spans, context, W3C wire format.

The control plane's per-stage timings (`NodePlan.stage_ms`) are
disconnected aggregates — they say how long stages take on average, not
what happened to ONE pod batch at 3 a.m. This module is the causal layer
underneath: Dapper-style spans (Sigelman et al. 2010) with

- **contextvars propagation** — a span opened anywhere on a thread (or
  across an ``await``) parents every span opened inside it, with explicit
  ``capture()``/``parent=`` hand-off for thread pools and batching seams
  (the batcher's drain worker, the solve window),
- **W3C ``traceparent``** carriage (``00-<trace32>-<span16>-<flags>``) so
  context crosses BOTH process boundaries the control plane has: the
  REST apiserver (HTTP header) and the solver sidecar (a field in the
  Solve RPC's JSON body),
- **monotonic timing via utils/clock** — durations come from
  ``Clock.monotonic()`` (steppable under FakeClock), wall anchoring from
  one ``now()`` sample at tracer construction, so spans order correctly
  even when the wall clock jumps,
- a **disabled fast path**: when tracing is off, ``span()`` returns one
  shared no-op singleton — no Span objects, no id generation, no
  contextvar writes. The reconcile loop pays a call that reads torch's
  profiler flag,
- **ranges on the device trace**: while a ``torch.profiler`` session
  records (``Solver.start_profiling``, or any ``torch.profiler.profile``),
  every span also opens a ``record_function`` range under its own name,
  whether tracing is on or off, so the spans sit on the profiler's clock
  beside the kernels they launched. The check reads torch's module flag
  ``torch.autograd.profiler._is_profiler_enabled`` and never imports
  torch,
- a **tally**: with tracing on, the tracer keeps per span name the count,
  the inclusive seconds, the self seconds (inclusive less the time its
  child spans cover) and the seconds under each parent name, plus named
  counters (``count``); ``totals()`` is a snapshot, so a reader takes one
  before and one after a window and subtracts.

Completed spans land in the FlightRecorder (trace/recorder.py), which
applies tail-based retention and serves `/debug/traces` + Chrome
trace-event export (``kpctl trace``).
"""

from __future__ import annotations

import contextvars
import os
import random
import sys
import threading
import time
from typing import Dict, Iterable, Optional, Sequence, Tuple

from ..utils.clock import Clock

# the active span on this thread/task (None = no ambient trace)
_CURRENT: contextvars.ContextVar[Optional["Span"]] = contextvars.ContextVar(
    "kpat_trace_span", default=None)

_FLAG_SAMPLED = 0x01

# torch.autograd.profiler once torch is loaded (None until then); its module
# flag ``_is_profiler_enabled`` is True while a torch.profiler session records
_AUTOGRAD_PROFILER = None

# span names the tally keeps apart (some carry a request path); later names
# share one row
_TALLY_NAMES = 1024
_TALLY_OTHER = "(other)"


def _load_profiler():
    """torch.autograd.profiler if torch is loaded, else None (until it is:
    a process without torch never records a range)."""
    global _AUTOGRAD_PROFILER
    mod = sys.modules.get("torch.autograd.profiler")
    if mod is None or not hasattr(mod, "_is_profiler_enabled"):
        return None
    _AUTOGRAD_PROFILER = mod
    return mod


def _recording():
    """torch.autograd.profiler while a profiler session records, else None."""
    prof = _AUTOGRAD_PROFILER or _load_profiler()
    return prof if prof is not None and prof._is_profiler_enabled else None


# ---- W3C traceparent (https://www.w3.org/TR/trace-context/) ---------------


def format_traceparent(trace_id: str, span_id: str,
                       sampled: bool = True) -> str:
    return f"00-{trace_id}-{span_id}-{_FLAG_SAMPLED if sampled else 0:02x}"


def parse_traceparent(header: Optional[str]
                      ) -> Optional[Tuple[str, str, bool]]:
    """``(trace_id, span_id, sampled)`` from a traceparent header, or None
    for anything malformed (a bad header must never fail a request)."""
    if not header or not isinstance(header, str):
        return None
    parts = header.strip().lower().split("-")
    if len(parts) != 4:
        return None
    version, trace_id, span_id, flags = parts
    if len(version) != 2 or len(trace_id) != 32 or len(span_id) != 16 \
            or len(flags) != 2:
        return None
    try:
        int(version, 16)
        int(trace_id, 16)
        int(span_id, 16)
        fl = int(flags, 16)
    except ValueError:
        return None
    if version == "ff" or set(trace_id) == {"0"} or set(span_id) == {"0"}:
        return None
    return trace_id, span_id, bool(fl & _FLAG_SAMPLED)


# ids come from a generator seeded once from the OS, and again in every
# forked child so that processes never share a sequence. One os.urandom per
# id, a system call, made tracing cost a 50k-pod wave 11 % of its time on an
# H100 host, against 2 % with this generator (one process, in turns)
_IDS = random.Random(os.urandom(16))
os.register_at_fork(after_in_child=lambda: _IDS.seed(os.urandom(16)))


def _new_trace_id() -> str:
    return f"{_IDS.getrandbits(128) or 1:032x}"     # all-zero ids are invalid


def _new_span_id() -> str:
    return f"{_IDS.getrandbits(64) or 1:016x}"


# ---- spans ----------------------------------------------------------------


class Span:
    """One timed operation. Use as a context manager:

        with trace.span("solver.solve", pods=32) as sp:
            ...
            sp.set(degraded=True)

    ``start`` is wall-anchored epoch seconds (monotonic offsets from the
    tracer's anchor — see Tracer), ``duration`` is monotonic seconds.
    ``links`` name causally-related spans in OTHER traces (the batching
    seams: a coalesced drain links every producer it served).
    """

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "start",
                 "duration", "attrs", "status", "links", "svc", "thread",
                 "_tracer", "_t0", "_token", "_up", "_child", "_range")

    def __init__(self, tracer: "Tracer", name: str, trace_id: str,
                 span_id: str, parent_id: Optional[str],
                 links: Sequence[Tuple[str, str]] = (),
                 attrs: Optional[Dict] = None):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.links = list(links)
        self.attrs = attrs or {}
        self.status = "ok"
        self.svc = tracer.service
        self.thread = threading.get_ident()
        self.start = 0.0
        self.duration = 0.0
        self._tracer = tracer
        self._t0 = 0.0
        self._token = None
        # the span this one opened inside (on this thread), the seconds
        # its own children took, and its profiler range
        self._up = None
        self._child = 0.0
        self._range = None

    # -- context-manager protocol --

    def __enter__(self) -> "Span":
        tr = self._tracer
        prof = _recording()
        if prof is not None:
            self._range = prof.record_function(self.name)
            self._range.__enter__()
        self._up = _CURRENT.get()
        self._t0 = tr.clock.monotonic()
        self.start = tr.anchor_wall + (self._t0 - tr.anchor_mono)
        self._token = _CURRENT.set(self)
        if tr.recorder is not None:
            tr.recorder.on_start(self.trace_id)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.duration = self._tracer.clock.monotonic() - self._t0
        if exc_type is not None:
            self.status = "error"
            self.attrs.setdefault("error", f"{exc_type.__name__}: {exc}")
        if self._token is not None:
            _CURRENT.reset(self._token)
            self._token = None
        up = self._up
        self._tracer.note(self.name, self.duration, self._child,
                          up.name if up is not None else None)
        if up is not None:
            up._child += self.duration
            self._up = None
        if self._tracer.recorder is not None:
            self._tracer.recorder.on_end(self)
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)
            self._range = None
        return False

    # -- helpers --

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def traceparent(self) -> str:
        return format_traceparent(self.trace_id, self.span_id)

    def to_dict(self) -> Dict:
        return {
            "name": self.name, "traceId": self.trace_id,
            "spanId": self.span_id, "parentId": self.parent_id,
            "svc": self.svc, "thread": self.thread,
            "start": round(self.start, 6),
            "durationMs": round(self.duration * 1000.0, 3),
            "status": self.status, "attrs": dict(self.attrs),
            "links": [list(l) for l in self.links],
        }


class _NoopSpan:
    """The disabled-path singleton: every operation is a no-op, every
    tracing call site stays branch-free. Identity-testable (tests assert
    the disabled path allocates nothing)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self

    def traceparent(self) -> None:
        return None


NOOP_SPAN = _NoopSpan()


class _RangeSpan:
    """Tracing off while a profiler session records: the span is the
    profiler range alone (no ids, no context, no tally)."""

    __slots__ = ("_range",)

    def __init__(self, rng):
        self._range = rng

    def __enter__(self):
        self._range.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb):
        self._range.__exit__(exc_type, exc, tb)
        return False

    def set(self, **attrs):
        return self

    def traceparent(self) -> None:
        return None


# ---- tracer ---------------------------------------------------------------


class Tracer:
    """Owns the enabled flag, the wall/monotonic anchor, and the recorder.

    One process-global instance (``get_tracer()``); the sidecar service
    marks its spans with ``svc`` so a merged export shows which process
    ran what.
    """

    def __init__(self, clock: Optional[Clock] = None,
                 service: str = "operator"):
        self.clock = clock or Clock()
        self.service = service
        self.enabled = False
        self.recorder = None
        self.anchor_wall = self.clock.now()
        self.anchor_mono = self.clock.monotonic()
        # the tally: name -> [count, seconds, self seconds, {parent name:
        # seconds}], and the counters
        self._tally: Dict[str, list] = {}
        self._counters: Dict[str, float] = {}
        self._tally_lock = threading.Lock()

    def enable(self, recorder=None, clock: Optional[Clock] = None) -> None:
        if clock is not None:
            self.clock = clock
        if recorder is None and self.recorder is None:
            from .recorder import FlightRecorder
            recorder = FlightRecorder()
        if recorder is not None:
            self.recorder = recorder
        self.anchor_wall = self.clock.now()
        self.anchor_mono = self.clock.monotonic()
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def note(self, name: str, seconds: float, child_seconds: float,
             parent: Optional[str]) -> None:
        """Add one closed span to the tally: its inclusive seconds, its
        self seconds (less ``child_seconds``, what its child spans took)
        and its seconds under ``parent``, the name of the span it opened
        inside."""
        with self._tally_lock:
            row = self._tally.get(name)
            if row is None:
                if len(self._tally) >= _TALLY_NAMES:
                    name = _TALLY_OTHER
                    row = self._tally.get(name)
                if row is None:
                    row = self._tally[name] = [0, 0.0, 0.0, {}]
            row[0] += 1
            row[1] += seconds
            row[2] += seconds - child_seconds
            if parent is not None:
                row[3][parent] = row[3].get(parent, 0.0) + seconds

    def count(self, name: str, n: float = 1) -> None:
        """Add ``n`` to the named counter; nothing while tracing is off."""
        if not self.enabled:
            return
        with self._tally_lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def totals(self) -> Dict[str, Dict]:
        """A snapshot of the tally since this tracer was made: ``spans``
        maps a name to its ``count``, ``seconds``, ``self_seconds`` and
        ``under`` (seconds by parent name); ``counters`` maps a name to
        its total."""
        with self._tally_lock:
            return {"spans": {n: {"count": r[0], "seconds": r[1],
                                  "self_seconds": r[2], "under": dict(r[3])}
                              for n, r in self._tally.items()},
                    "counters": dict(self._counters)}

    def span(self, name: str, parent=_CURRENT, links: Iterable = (),
             **attrs):
        """Open a span. ``parent`` accepts a live Span, a traceparent
        header string (remote parent), a ``(trace_id, span_id)`` pair, or
        None to force a new root; omitted = the ambient current span.
        ``links`` is an iterable of the same forms. Tracing off, this is
        the shared no-op span, or while a profiler session records its
        range alone."""
        if not self.enabled:
            prof = _recording()
            return NOOP_SPAN if prof is None else _RangeSpan(
                prof.record_function(name))
        if parent is _CURRENT:
            parent = _CURRENT.get()
        trace_id = parent_id = None
        if isinstance(parent, Span):
            trace_id, parent_id = parent.trace_id, parent.span_id
        elif isinstance(parent, str):
            parsed = parse_traceparent(parent)
            if parsed is not None:
                trace_id, parent_id = parsed[0], parsed[1]
        elif isinstance(parent, tuple) and len(parent) == 2:
            trace_id, parent_id = parent
        if trace_id is None:
            trace_id = _new_trace_id()
        link_ids = []
        for l in links:
            if isinstance(l, Span):
                link_ids.append((l.trace_id, l.span_id))
            elif isinstance(l, str):
                p = parse_traceparent(l)
                if p is not None:
                    link_ids.append((p[0], p[1]))
            elif isinstance(l, tuple) and len(l) == 2:
                link_ids.append(tuple(l))
        svc = attrs.pop("svc", None) if attrs else None
        sp = Span(self, name, trace_id, _new_span_id(), parent_id,
                  links=link_ids, attrs=attrs or None)
        if svc:
            # per-span service override: the sidecar handler marks its
            # subtree even when it shares the operator's process (the
            # in-process sidecar of cli --sidecar-address)
            sp.svc = svc
        return sp


_TRACER = Tracer()


def get_tracer() -> Tracer:
    return _TRACER


# ---- module-level convenience API (what call sites import) ---------------


def enabled() -> bool:
    return _TRACER.enabled


def enable(recorder=None, clock: Optional[Clock] = None) -> None:
    _TRACER.enable(recorder=recorder, clock=clock)


def disable() -> None:
    _TRACER.disable()


def span(name: str, parent=_CURRENT, links: Iterable = (), **attrs):
    return _TRACER.span(name, parent=parent, links=links, **attrs)


def count(name: str, n: float = 1) -> None:
    """Add ``n`` to a named counter of the tally; a no-op while tracing is
    off."""
    _TRACER.count(name, n)


def totals() -> Dict[str, Dict]:
    """The tally's snapshot (``Tracer.totals``)."""
    return _TRACER.totals()


def current() -> Optional[Span]:
    """The ambient span, or None. Cheap when disabled."""
    if not _TRACER.enabled:
        return None
    return _CURRENT.get()


def capture() -> Optional[str]:
    """The ambient span's traceparent header (for hand-off across thread
    pools / wires), or None."""
    sp = current()
    return sp.traceparent() if sp is not None else None


def annotate(**attrs) -> None:
    """Attach attributes to the ambient span, if any."""
    sp = current()
    if sp is not None:
        sp.set(**attrs)


def recorder():
    return _TRACER.recorder
