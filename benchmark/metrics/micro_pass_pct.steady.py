"""micro_pass_pct.steady: share of the window's passes that the microloop served
(the solver's ``micro_solves``): not a full build, and not a microloop abort."""


def read(ctx):
    served = [r["micro"] for r in ctx.records if "micro" in r]
    return 100.0 * sum(served) / len(served) if served else None
