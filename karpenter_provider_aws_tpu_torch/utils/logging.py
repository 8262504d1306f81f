"""Structured logging + change-noise suppression.

Mirror of the reference's logging surface (SURVEY §5): zap-style
structured logs (knative ``logging.FromContext``) and the
``pretty.ChangeMonitor`` idiom — controllers that reconcile every few
seconds log a fact only when it CHANGES, not on every pass (reference
pkg/providers/instancetype/instancetype.go:150-152 logs the discovered
instance-type count only on delta).

Python side: stdlib logging with a key=value structured formatter, one
logger per component under the "karpenter" root, and a ChangeMonitor
whose entries expire so a steady state is re-asserted once per TTL (the
reference expires entries after 24h).
"""

from __future__ import annotations

import logging
import threading
from typing import Dict, Optional, Tuple

from .clock import Clock

_ROOT = "karpenter"
_configured = False
_configure_lock = threading.Lock()


class _KVFormatter(logging.Formatter):
    """`ts level logger message key=value ...` — grep-friendly, one line."""

    def format(self, record: logging.LogRecord) -> str:
        base = (f"{self.formatTime(record, '%Y-%m-%dT%H:%M:%S')} "
                f"{record.levelname} {record.name} {record.getMessage()}")
        extra = getattr(record, "kv", None)
        if extra:
            base += " " + " ".join(f"{k}={v}" for k, v in sorted(extra.items()))
        return base


def configure(level: str = "INFO") -> None:
    """Install the structured handler on the karpenter root (idempotent;
    re-invocation only adjusts the level — the CLI's --log-level)."""
    global _configured
    with _configure_lock:
        root = logging.getLogger(_ROOT)
        root.setLevel(getattr(logging, level.upper(), logging.INFO))
        if not _configured:
            h = logging.StreamHandler()
            h.setFormatter(_KVFormatter())
            root.addHandler(h)
            root.propagate = False
            _configured = True


def get_logger(component: str) -> "StructuredLogger":
    return StructuredLogger(logging.getLogger(f"{_ROOT}.{component}"))


def _current_span():
    """The ambient trace span, or None. Imported lazily (and cached) so
    this module stays importable before/without the trace package."""
    global _trace_current
    if _trace_current is None:
        try:
            from ..trace import current as _trace_current
        except Exception:
            def _trace_current():
                return None
    return _trace_current()


_trace_current = None


class StructuredLogger:
    """Thin facade adding key=value fields: log.info("msg", key=val).

    A line emitted inside an active trace span carries ``trace=<id>``
    automatically, so grep output correlates with ``/debug/traces``
    (`kpctl trace show <id>`) and with burn-triggered profile captures —
    the log line, the span tree, and the profile snapshot of one slow
    pass all share the id. Free when tracing is off (one attribute
    read, trace/span.py's disabled fast path)."""

    def __init__(self, logger: logging.Logger):
        self._logger = logger

    def _log(self, level: int, msg: str, kv: dict) -> None:
        if self._logger.isEnabledFor(level):
            sp = _current_span()
            if sp is not None and "trace" not in kv:
                kv["trace"] = sp.trace_id
            self._logger.log(level, msg, extra={"kv": kv})

    def debug(self, msg: str, **kv) -> None:
        self._log(logging.DEBUG, msg, kv)

    def info(self, msg: str, **kv) -> None:
        self._log(logging.INFO, msg, kv)

    def warning(self, msg: str, **kv) -> None:
        self._log(logging.WARNING, msg, kv)

    def error(self, msg: str, **kv) -> None:
        self._log(logging.ERROR, msg, kv)


class ChangeMonitor:
    """Log-on-delta gate (reference pretty.ChangeMonitor): ``has_changed``
    returns True the first time a key is seen, whenever its value
    differs from the last observation, or after the TTL re-arms it — so
    a 10 s reconcile loop states a steady fact once per TTL instead of
    8,640 times a day."""

    def __init__(self, clock: Optional[Clock] = None, ttl: float = 24 * 3600.0):
        self._clock = clock or Clock()
        self._ttl = ttl
        self._lock = threading.Lock()
        self._seen: Dict[str, Tuple[object, float]] = {}

    def has_changed(self, key: str, value: object) -> bool:
        now = self._clock.now()
        with self._lock:
            prev = self._seen.get(key)
            if prev is not None and prev[0] == value and now - prev[1] < self._ttl:
                return False
            self._seen[key] = (value, now)
            return True
