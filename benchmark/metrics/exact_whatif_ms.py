"""exact_whatif_ms: mean ms of the exact what-if (``Solver.solve_relaxed``) over
the evaluations that ran one."""


def read(ctx):
    return ctx.mean("exact_whatif")
