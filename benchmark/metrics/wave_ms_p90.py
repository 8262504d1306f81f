"""wave_ms_p90: the 90th percentile of all the window's wave times (ms): the
tail, which the host paces."""


def read(ctx):
    from benchmark.harness import quantile
    return quantile([r["wave"] for r in ctx.records if "wave" in r], 90, ctx.log)
