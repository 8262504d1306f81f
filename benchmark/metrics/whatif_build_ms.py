"""whatif_build_ms: mean ms per evaluation of ``ConsolidationEngine.probe`` less
its ``Solver.probe_batch`` call: the host's build of the what-if problems."""


def read(ctx):
    return ctx.mean("whatif_build_ms")
