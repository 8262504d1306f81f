"""decode_ms.steady: mean ms per pass of the solve's ``download`` and ``decode``
stages (``NodePlan.stage_ms``; the download holds the changed-plan
fingerprint's wait for the card and, where the plan moved, the fetch)."""


def read(ctx):
    return ctx.mean("decode_ms")
