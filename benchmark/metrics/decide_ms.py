"""decide_ms: the window over the consolidation evaluations in it, in ms: all its
time over all its evaluations."""


def read(ctx):
    return 1e3 * ctx.window_s / len(ctx.records) if ctx.records else None
