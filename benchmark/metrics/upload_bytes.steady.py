"""upload_bytes.steady: mean bytes per pass that the solver uploaded to the card
(``Solver.link_stats["upload_bytes"]``): in the microloop the resident input
cache's changed blocks with their index, in one scatter."""


def read(ctx):
    return ctx.mean("upload_bytes")
