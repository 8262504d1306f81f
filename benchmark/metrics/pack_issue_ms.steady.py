"""pack_issue_ms.steady: mean ms per pass of the solve's ``compute`` stage
(``NodePlan.stage_ms``): in the microloop the host's issue of the grouped-FFD
scan against the resident problem, not the card's time."""


def read(ctx):
    return ctx.mean("scan_issue_ms")
