"""delta_build_ms.steady: mean ms per pass of ``IncrementalProblemBuilder.build``
(the harness's ``build`` span): the incremental build, or the full build it
falls back to."""


def read(ctx):
    return ctx.mean("build")
