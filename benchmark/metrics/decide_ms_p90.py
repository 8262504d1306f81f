"""decide_ms_p90: the 90th percentile of all the window's evaluation times (ms). A
51-s window holds about 110 evaluations, so about 11 lie beyond it."""


def read(ctx):
    from benchmark.harness import quantile
    return quantile([r["evaluation"] for r in ctx.records if "evaluation" in r], 90, ctx.log)
