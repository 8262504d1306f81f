"""device_idle_pct.consolidate: share of the traced evaluations' time in which no
operation ran on the card."""


def read(ctx):
    return ctx.idle_pct()
