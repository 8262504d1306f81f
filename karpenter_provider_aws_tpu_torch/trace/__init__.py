"""End-to-end tracing & flight recorder (docs/reference/tracing.md).

Causal spans from REST admission through informer delta, batch window,
solve-window coalescing, the pipelined device waves, decode, CreateFleet
and NodeClaim registration — with tail-sampled retention and Chrome
trace-event (Perfetto) export. Zero dependencies beyond the stdlib.

    from karpenter_provider_aws_tpu_torch import trace

    trace.enable()                      # flight recorder attached
    with trace.span("my.op", key=1) as sp:
        ...
        sp.set(result="ok")

Disabled (the default), every call site costs a read of torch's profiler
flag, and ``span()`` returns a shared no-op singleton — no allocation. While a ``torch.profiler`` session records, every span is also
a ``record_function`` range of its name. Enabled, the tracer tallies
spans and counters:

    trace.count("scan.steps", 32)       # no-op while disabled
    before = trace.totals()             # {"spans": {...}, "counters": {...}}
"""

from .recorder import FlightRecorder, ImportedSpan
from .span import (NOOP_SPAN, Span, Tracer, annotate, capture, count,
                   current, disable, enable, enabled, format_traceparent,
                   get_tracer, parse_traceparent, recorder, span, totals)

__all__ = [
    "FlightRecorder", "ImportedSpan", "NOOP_SPAN", "Span", "Tracer",
    "annotate", "capture", "count", "current", "disable", "enable",
    "enabled", "format_traceparent", "get_tracer", "parse_traceparent",
    "recorder", "span", "totals",
]
