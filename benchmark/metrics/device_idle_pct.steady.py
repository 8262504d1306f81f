"""device_idle_pct.steady: share of the traced passes' time in which no
operation ran on the card."""


def read(ctx):
    return ctx.idle_pct()
