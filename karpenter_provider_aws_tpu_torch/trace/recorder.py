"""Flight recorder: bounded in-process trace retention with TAIL sampling.

Head-based samplers decide at trace start and therefore keep a uniform
slice of boring traffic while dropping the one 3 a.m. solve that
degraded. This recorder decides at trace END (Canopy, Kaldor et al.
2017): every completed trace enters a bounded ring, and traces that

- **errored** (any span finished with an exception),
- **degraded** (any span carries a truthy ``degraded`` attribute — the
  solver's ladder, host-FFD fallback, device retries), or
- **blew the latency budget** (end-to-end wall time over
  ``latency_budget_ms``)

are additionally pinned in a separate retained set that survives ring
wrap-around — the evidence stays until ``retained`` newer incidents push
it out. Everything is O(1) per span and bounded: the recorder can run
forever inside the operator.

Serving: ``debug_doc(path, query)`` renders the ``/debug/traces`` routes
(both the REST apiserver and the CLI's metrics server mount it), and
``to_chrome(trace_id)`` emits Chrome trace-event JSON loadable in
Perfetto / chrome://tracing next to xprof device traces (``kpctl trace
export``).
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, List, Optional


class _Rec:
    """One trace's accumulating state."""

    __slots__ = ("trace_id", "spans", "open", "retain_reason")

    def __init__(self, trace_id: str):
        self.trace_id = trace_id
        self.spans: List = []
        self.open = 0
        self.retain_reason: Optional[str] = None


class ImportedSpan:
    """A span completed in ANOTHER process, rebuilt from its wire dict
    (Span.to_dict form — the sidecar ships these back in the Solve
    response). Quacks enough like trace/span.py Span for every recorder
    query and the Chrome export."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "svc",
                 "thread", "start", "duration", "attrs", "status", "links")

    def __init__(self, d: Dict):
        self.name = d.get("name", "")
        self.trace_id = d.get("traceId", "")
        self.span_id = d.get("spanId", "")
        self.parent_id = d.get("parentId")
        self.svc = d.get("svc", "remote")
        self.thread = d.get("thread", 0)
        self.start = float(d.get("start", 0.0))
        self.duration = float(d.get("durationMs", 0.0)) / 1000.0
        self.attrs = dict(d.get("attrs", {}))
        self.status = d.get("status", "ok")
        self.links = [tuple(l) for l in d.get("links", ())]

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


class FlightRecorder:
    def __init__(self, ring: int = 256, retained: int = 64,
                 latency_budget_ms: float = 1000.0):
        # instrumented (introspect/contention.py): every span end takes
        # this lock; contention here means tracing itself is a bottleneck
        from ..introspect import contention
        self._lock = contention.lock("flight_recorder")
        self.ring_size = max(int(ring), 1)
        self.retained_size = max(int(retained), 1)
        self.latency_budget_ms = float(latency_budget_ms)
        # trace_id -> _Rec; insertion-ordered so eviction is oldest-first
        self._active: "OrderedDict[str, _Rec]" = OrderedDict()
        self._ring: "OrderedDict[str, _Rec]" = OrderedDict()
        self._retained: "OrderedDict[str, _Rec]" = OrderedDict()
        self.stats = {"started": 0, "completed": 0, "retained": 0,
                      "dropped": 0, "discarded": 0}

    def introspect_stats(self) -> Dict:
        """Introspection snapshot (``stats`` is already the raw counter
        dict attribute): counters + live ring/retained occupancy."""
        with self._lock:
            out: Dict = dict(self.stats)
            out.update({"active": len(self._active),
                        "ring": len(self._ring),
                        "retained_pinned": len(self._retained),
                        "latency_budget_ms": self.latency_budget_ms})
            return out

    # ---- span lifecycle (called by the tracer) ----------------------------

    def on_start(self, trace_id: str) -> None:
        with self._lock:
            rec = self._active.get(trace_id)
            if rec is None:
                # a finalized trace can re-open: a sidecar RPC (or a late
                # linked controller span) joins an already-completed trace
                rec = self._ring.pop(trace_id, None) \
                    or self._retained.pop(trace_id, None)
                if rec is None:
                    rec = _Rec(trace_id)
                    self.stats["started"] += 1
                self._active[trace_id] = rec
                # bound the active set: a span leaked open forever must
                # not grow memory without bound
                while len(self._active) > 4 * self.ring_size:
                    self._active.popitem(last=False)
                    self.stats["dropped"] += 1
            rec.open += 1

    def on_end(self, span) -> None:
        with self._lock:
            rec = self._active.get(span.trace_id)
            if rec is None:     # evicted while open; drop the orphan span
                self.stats["dropped"] += 1
                return
            rec.spans.append(span)
            rec.open -= 1
            if rec.open <= 0:
                del self._active[span.trace_id]
                self._finalize(rec)

    # ---- cross-process span import ----------------------------------------

    def ingest(self, span_dicts) -> int:
        """Import spans completed in another process (wire-dict form).

        Spans join their trace's accumulating record when it is still
        OPEN here (the normal case: SolverClient ingests inside the RPC
        call, under the caller's still-open span) so the tail decision at
        trace end sees the remote subtree too — a solve that degraded
        only in the sidecar still pins the whole trace. Already-finalized
        traces re-run the retention decision with the new spans. Dedupe
        is by span id: the in-process sidecar (cli --sidecar-address)
        shares this recorder, so its spans arrive twice."""
        added = 0
        by_tid: Dict[str, List[ImportedSpan]] = {}
        for d in span_dicts:
            sp = ImportedSpan(d)
            if sp.trace_id and sp.span_id:
                by_tid.setdefault(sp.trace_id, []).append(sp)
        with self._lock:
            for tid, spans in by_tid.items():
                rec = self._active.get(tid)
                refinalize = False
                if rec is None:
                    rec = self._ring.pop(tid, None) \
                        or self._retained.pop(tid, None)
                    refinalize = rec is not None
                if rec is None:
                    rec = _Rec(tid)
                    refinalize = True
                    self.stats["started"] += 1
                seen = {s.span_id for s in rec.spans}
                for sp in spans:
                    if sp.span_id in seen:
                        continue
                    rec.spans.append(sp)
                    seen.add(sp.span_id)
                    added += 1
                if refinalize:
                    if tid in self._retained:
                        del self._retained[tid]
                    if rec.retain_reason is not None:
                        self.stats["retained"] -= 1   # re-decided below
                    rec.retain_reason = None
                    self._finalize(rec, count=False)
        return added

    # ---- tail-sampling decision -------------------------------------------

    def _finalize(self, rec: _Rec, count: bool = True) -> None:
        if count:
            self.stats["completed"] += 1
        reason = self._retain_reason(rec)
        if reason == "discard":
            self.stats["discarded"] += 1
            return
        self._ring[rec.trace_id] = rec
        while len(self._ring) > self.ring_size:
            self._ring.popitem(last=False)
        if reason is not None:
            rec.retain_reason = reason
            self.stats["retained"] += 1
            self._retained[rec.trace_id] = rec
            while len(self._retained) > self.retained_size:
                self._retained.popitem(last=False)

    def _retain_reason(self, rec: _Rec) -> Optional[str]:
        """The tail-based policy, in precedence order. ``discard`` (a root
        span attribute) drops no-op traces entirely — e.g. a disruption
        reconcile that found nothing is not evidence of anything."""
        error = degraded = False
        for s in rec.spans:
            if s.status == "error":
                error = True
            if s.attrs.get("degraded"):
                degraded = True
        if error:
            return "error"
        if degraded:
            return "degraded"
        roots = [s for s in rec.spans if s.parent_id is None]
        if roots and all(s.attrs.get("discard") for s in roots):
            return "discard"
        if self._duration_ms(rec) > self.latency_budget_ms:
            return "slow"
        return None

    @staticmethod
    def _duration_ms(rec: _Rec) -> float:
        if not rec.spans:
            return 0.0
        t0 = min(s.start for s in rec.spans)
        t1 = max(s.start + s.duration for s in rec.spans)
        return (t1 - t0) * 1000.0

    # ---- queries ----------------------------------------------------------

    def _all(self) -> "OrderedDict[str, _Rec]":
        # retained traces may have fallen out of the ring: union, ring
        # order first (oldest → newest), then retained-only stragglers
        out: "OrderedDict[str, _Rec]" = OrderedDict()
        for tid, rec in self._retained.items():
            out[tid] = rec
        for tid, rec in self._ring.items():
            out[tid] = rec
        return out

    def summaries(self) -> List[Dict]:
        with self._lock:
            recs = list(self._all().values())
        out = []
        for rec in recs:
            roots = [s for s in rec.spans if s.parent_id is None]
            root = min(roots or rec.spans, key=lambda s: s.start)
            out.append({
                "traceId": rec.trace_id,
                "root": root.name,
                "svc": sorted({s.svc for s in rec.spans}),
                "spans": len(rec.spans),
                "start": round(min(s.start for s in rec.spans), 6),
                "durationMs": round(self._duration_ms(rec), 3),
                "retained": rec.retain_reason,
            })
        out.sort(key=lambda d: d["start"], reverse=True)
        return out

    def get(self, trace_id: str) -> Optional[List]:
        with self._lock:
            rec = (self._retained.get(trace_id) or self._ring.get(trace_id)
                   or self._active.get(trace_id))
            return list(rec.spans) if rec is not None else None

    # ---- Chrome trace-event export (Perfetto / chrome://tracing) ----------

    def to_chrome(self, trace_id: str) -> Optional[Dict]:
        """Chrome trace-event JSON: one complete ("X") event per span,
        process rows per service (operator / sidecar), thread rows per OS
        thread — loadable in Perfetto next to an xprof device trace."""
        spans = self.get(trace_id)
        if spans is None:
            return None
        pids: Dict[str, int] = {}
        events: List[Dict] = []
        for s in spans:
            pid = pids.setdefault(s.svc, len(pids) + 1)
            args = {"traceId": s.trace_id, "spanId": s.span_id,
                    "parentId": s.parent_id, "status": s.status}
            args.update({k: v for k, v in s.attrs.items()
                         if isinstance(v, (str, int, float, bool))})
            if s.links:
                args["links"] = [f"{t}:{sp}" for t, sp in s.links]
            events.append({
                "name": s.name, "ph": "X", "cat": "kpat",
                "ts": round(s.start * 1e6, 3),
                "dur": round(s.duration * 1e6, 3),
                "pid": pid, "tid": s.thread, "args": args,
            })
        for svc, pid in pids.items():
            events.append({"ph": "M", "name": "process_name", "pid": pid,
                           "tid": 0, "args": {"name": svc}})
        return {"displayTimeUnit": "ms", "traceEvents": events}

    # ---- HTTP surface (mounted by kube/httpserver.py and cli.py) ----------

    def debug_doc(self, path: str, query: Dict[str, List[str]]
                  ) -> Optional[Dict]:
        """Render a ``/debug/traces`` route; None = not found.

        GET /debug/traces                 → {"traces": [...], "stats": ...}
        GET /debug/traces/{id}            → {"traceId", "spans": [...]}
        GET /debug/traces/{id}?format=chrome → Chrome trace-event JSON
        """
        parts = [p for p in path.split("/") if p]
        if parts[:2] != ["debug", "traces"]:
            return None
        if len(parts) == 2:
            return {"traces": self.summaries(), "stats": dict(self.stats),
                    "latencyBudgetMs": self.latency_budget_ms,
                    "ring": self.ring_size, "retained": self.retained_size}
        if len(parts) == 3:
            tid = parts[2]
            if query.get("format", [""])[0] == "chrome":
                return self.to_chrome(tid)
            spans = self.get(tid)
            if spans is None:
                return None
            return {"traceId": tid,
                    "spans": [s.to_dict() for s in spans]}
        return None
