"""probe_device_ms: device ms per traced evaluation of the operations that the
batched probe (``Solver.probe_batch``) ran, from the trace."""


def read(ctx):
    if not ctx.trace or not ctx.traced:
        return None
    return 1e3 * ctx.trace["span_device_s"].get("probe_batch", 0.0) / len(ctx.traced) or None
