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
  contextvar writes. The reconcile loop pays a single attribute read.

Completed spans land in the FlightRecorder (trace/recorder.py), which
applies tail-based retention and serves `/debug/traces` + Chrome
trace-event export (``kpctl trace``).
"""

from __future__ import annotations

import contextvars
import os
import threading
import time
from typing import Dict, Iterable, Optional, Sequence, Tuple

from ..utils.clock import Clock

# the active span on this thread/task (None = no ambient trace)
_CURRENT: contextvars.ContextVar[Optional["Span"]] = contextvars.ContextVar(
    "kpat_trace_span", default=None)

_FLAG_SAMPLED = 0x01


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


def _new_trace_id() -> str:
    return os.urandom(16).hex()


def _new_span_id() -> str:
    return os.urandom(8).hex()


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
                 "_tracer", "_t0", "_token")

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

    # -- context-manager protocol --

    def __enter__(self) -> "Span":
        tr = self._tracer
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
        if self._tracer.recorder is not None:
            self._tracer.recorder.on_end(self)
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

    def span(self, name: str, parent=_CURRENT, links: Iterable = (),
             **attrs):
        """Open a span. ``parent`` accepts a live Span, a traceparent
        header string (remote parent), a ``(trace_id, span_id)`` pair, or
        None to force a new root; omitted = the ambient current span.
        ``links`` is an iterable of the same forms."""
        if not self.enabled:
            return NOOP_SPAN
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
