"""scan_issue_ms.wave: mean ms per wave of the solve's ``compute`` stage
(``NodePlan.stage_ms``): on the pipelined path the host's issue of the
grouped-FFD scan, not the card's time."""


def read(ctx):
    return ctx.mean("scan_issue_ms")
