"""Cluster introspection layer (docs/reference/introspection.md).

A process-wide provider registry every stateful subsystem reports cheap
``stats()`` into, a bounded-ring sampler off the hot path, rolling SLO
burn tracking against the paper's 200 ms / 2% bars, and two debug
surfaces rendered by both the metrics server and the REST apiserver:

    GET /debug/statusz            human-readable subsystem state
    GET /debug/vars[?series=1]    machine-readable JSON (+ ring series)

``kpctl top`` renders /debug/vars as a live terminal view; tools/soak.py
and debug.Monitor persist the same snapshots as per-subsystem
time-series in soak artifacts.

Usage (subsystem side):

    from karpenter_provider_aws_tpu_torch import introspect
    introspect.registry().register("my_subsystem", my_obj.stats)

The registry is process-wide and replace-by-name (a rebuilt Operator
re-registers over its predecessor); the sampler and SLO tracker are
per-Operator, with the most recent one published here for the HTTP
surfaces (`set_sampler`), mirroring how trace.enable() publishes the
flight recorder.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

from . import contention
from .headroom import HeadroomRegistry
from .profiler import BurnCapture, SamplingProfiler
from .registry import IntrospectRegistry, StatsProvider
from .sampler import Sampler
from .slo import SloTracker

__all__ = [
    "IntrospectRegistry", "Sampler", "SloTracker", "StatsProvider",
    "SamplingProfiler", "BurnCapture", "HeadroomRegistry", "contention",
    "registry", "sampler", "set_sampler", "statusz_text", "vars_doc",
    "debug_doc", "profiler_instance", "set_profiler", "enable_profiling",
    "profiler_stats", "burn_capture", "set_burn_capture",
    "explain_ring", "set_explain_ring",
    "headroom_registry", "set_headroom",
]

_REGISTRY = IntrospectRegistry()
_SAMPLER: Optional[Sampler] = None
_PROFILER: Optional[SamplingProfiler] = None
_BURN_CAPTURE: Optional[BurnCapture] = None
_EXPLAIN = None   # solver/explain.py DecisionAuditRing
_HEADROOM: Optional[HeadroomRegistry] = None
_STARTED_AT = time.time()


def registry() -> IntrospectRegistry:
    """The process-wide provider registry."""
    return _REGISTRY


def sampler() -> Optional[Sampler]:
    """The most recently published Sampler (None before any Operator)."""
    return _SAMPLER


def set_sampler(s: Optional[Sampler]) -> None:
    global _SAMPLER
    _SAMPLER = s


# ---- the sampling profiler (docs/reference/profiling.md) ------------------

def profiler_instance() -> Optional[SamplingProfiler]:
    """The published whole-process sampling profiler, or None when
    profiling is off (the default — nothing is constructed, sampled, or
    allocated until ``enable_profiling``/``set_profiler``)."""
    return _PROFILER


def set_profiler(p: Optional[SamplingProfiler]) -> None:
    global _PROFILER
    _PROFILER = p


def enable_profiling(hz: float = 50.0) -> SamplingProfiler:
    """Construct, publish, and start the daemon sampler (the CLI's
    ``--profile``). Idempotent-ish: an already-published profiler is
    restarted rather than replaced (its aggregate survives)."""
    global _PROFILER
    if _PROFILER is None:
        _PROFILER = SamplingProfiler(hz=hz)
    return _PROFILER.start()


def profiler_stats() -> Dict:
    """The ``profiler`` introspection provider: stats when running, the
    explicit disabled marker otherwise (a provider must never be
    empty)."""
    p = _PROFILER
    return p.stats() if p is not None else {"enabled": 0.0}


def burn_capture() -> Optional[BurnCapture]:
    return _BURN_CAPTURE


def set_burn_capture(bc: Optional[BurnCapture]) -> None:
    global _BURN_CAPTURE
    _BURN_CAPTURE = bc


def explain_ring():
    """The published decision-audit ring (solver/explain.py
    DecisionAuditRing), or None before any Operator wired one — the
    store behind /debug/explain and `kpctl explain`."""
    return _EXPLAIN


def set_explain_ring(ring) -> None:
    global _EXPLAIN
    _EXPLAIN = ring


def headroom_registry() -> Optional[HeadroomRegistry]:
    """The published saturation observatory (introspect/headroom.py
    HeadroomRegistry), or None before any Operator wired one — the
    store behind /debug/headroom and `kpctl headroom`."""
    return _HEADROOM


def set_headroom(hr: Optional[HeadroomRegistry]) -> None:
    global _HEADROOM
    _HEADROOM = hr


# ---- the two debug documents ---------------------------------------------

def vars_doc(include_series: bool = False) -> Dict:
    """The /debug/vars JSON document: current stats per provider, plus
    (on request) the sampler's bounded ring series. Machine-readable —
    the backbone of kpctl top and the soak artifact."""
    doc: Dict = {
        "now": round(time.time(), 3),
        "uptimeSeconds": round(time.time() - _STARTED_AT, 1),
        "providers": _REGISTRY.collect(),
    }
    s = _SAMPLER
    if s is not None:
        doc["sampler"] = {"samples": s.samples_taken, "ring": s.ring}
        if include_series:
            doc["series"] = s.series()
    return doc


def statusz_text() -> str:
    """The /debug/statusz page: the same snapshot, for humans. Plain
    text — readable in a terminal (`curl .../debug/statusz`) without
    any tooling."""
    snap = _REGISTRY.collect()
    lines: List[str] = [
        "karpenter-tpu statusz",
        f"uptime: {time.time() - _STARTED_AT:.0f}s   "
        f"providers: {len(snap)}",
        "",
    ]
    if not snap:
        lines.append("(no providers registered yet — operator still "
                     "constructing)")
    for name in sorted(snap):
        stats = snap[name]
        lines.append(f"== {name} ==")
        if not stats:
            lines.append("  (empty)")
        for k in sorted(stats):
            v = stats[k]
            if isinstance(v, float):
                v = f"{v:g}"
            lines.append(f"  {k}: {v}")
        lines.append("")
    return "\n".join(lines) + "\n"


def debug_doc(path: str, query: Dict[str, List[str]]):
    """Route /debug/statusz, /debug/vars, and /debug/pprof/* for an
    HTTP handler.

    Returns ``(body_bytes, content_type)`` or None when the path is not
    ours — the same shape both kube/httpserver.py and cli.py mount next
    to the flight recorder's /debug/traces."""
    import json
    p = path.rstrip("/")
    if p == "/debug/statusz":
        return statusz_text().encode(), "text/plain; charset=utf-8"
    if p == "/debug/vars":
        series = query.get("series", ["0"])[0] in ("1", "true")
        return (json.dumps(vars_doc(include_series=series)).encode(),
                "application/json")
    if p == "/debug/explain":
        # the decision-audit surface (docs/reference/explain.md):
        # ?pod= / ?nodeclaim= / ?pass= look one decision up; bare GET
        # lists the ring. Served on BOTH HTTP servers like the rest.
        ring = _EXPLAIN
        doc = (ring.doc(query) if ring is not None
               else {"enabled": False,
                     "message": "no decision-audit ring published "
                                "(operator still constructing?)"})
        return json.dumps(doc).encode(), "application/json"
    if p == "/debug/headroom":
        # the saturation observatory (docs/reference/headroom.md): the
        # ranked first-to-break table of every bounded resource. Served
        # on BOTH HTTP servers like the rest.
        hr = _HEADROOM
        doc = (hr.doc() if hr is not None
               else {"enabled": False,
                     "message": "no headroom registry published "
                                "(operator still constructing?)"})
        return json.dumps(doc).encode(), "application/json"
    if p.startswith("/debug/pprof"):
        return _pprof_doc(p, query)
    return None


def _pprof_doc(p: str, query: Dict[str, List[str]]):
    """The profiling read surface (docs/reference/profiling.md):

        /debug/pprof/profile                folded collapsed stacks (text;
                                            the flamegraph.pl/speedscope
                                            input), ?format=json|chrome
        /debug/pprof/contention             lock/queue accounting (JSON)
        /debug/pprof/lockorder              lock acquisition-order graph +
                                            deadlock cycles w/ witness
                                            stacks (JSON)
        /debug/pprof/device                 device cost model (JSON)
        /debug/pprof/captures               burn-triggered snapshots (JSON)
    """
    import json

    def _json(doc):
        return json.dumps(doc).encode(), "application/json"

    if p == "/debug/pprof/profile":
        fmt = query.get("format", ["folded"])[0]
        prof = _PROFILER
        if prof is None:
            if fmt == "folded":
                return (b"# profiler disabled (--profile)\n",
                        "text/plain; charset=utf-8")
            return _json({"enabled": False})
        if fmt == "chrome":
            return _json(prof.to_chrome())
        if fmt == "json":
            try:
                n = min(max(int(query.get("n", ["40"])[0]), 1), 1000)
            except ValueError:
                n = 40
            return _json({**prof.stats(), "top": prof.top(n)})
        return prof.folded().encode(), "text/plain; charset=utf-8"
    if p == "/debug/pprof/contention":
        return _json(contention.detail())
    if p == "/debug/pprof/lockorder":
        return _json(contention.lockorder_detail())
    if p == "/debug/pprof/device":
        from ..solver import costmodel
        return _json(costmodel.model().summary())
    if p == "/debug/pprof/captures":
        bc = _BURN_CAPTURE
        return _json(bc.doc() if bc is not None else
                     {"captures": [], "total": 0})
    return None
