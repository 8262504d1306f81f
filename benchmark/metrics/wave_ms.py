"""wave_ms: the window over the waves planned in it, in ms: all its time over all its
waves, from pending pods to their NodePlan on the host."""


def read(ctx):
    return 1e3 * ctx.window_s / len(ctx.records) if ctx.records else None
