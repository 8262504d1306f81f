"""staging_ms.wave: mean ms per wave of the solve's ``build`` and ``upload`` stages
(``NodePlan.stage_ms``: the fused inputs staged and copied to the card)."""


def read(ctx):
    return ctx.mean("staging_ms")
