"""decode_ms.wave: mean ms per wave of the solve's ``download`` and ``decode``
stages (``NodePlan.stage_ms``; the download holds the wait for the card)."""


def read(ctx):
    return ctx.mean("decode_ms")
