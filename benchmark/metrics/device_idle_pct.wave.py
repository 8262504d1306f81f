"""device_idle_pct.wave: share of the traced waves' time in which no operation ran
on the card (the union of the device intervals in the trace)."""


def read(ctx):
    return ctx.idle_pct()
