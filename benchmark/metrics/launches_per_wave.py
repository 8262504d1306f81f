"""launches_per_wave: CUDA kernel launch calls in the profiler's runtime events
over the traced waves, per wave."""


def read(ctx):
    if not ctx.trace or not ctx.traced:
        return None
    return ctx.trace["launches"] / len(ctx.traced)
