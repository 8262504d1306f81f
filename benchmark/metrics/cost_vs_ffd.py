"""cost_vs_ffd: $/hr of the checked plans over the plain reference FFD's $/hr on
the same inputs (``reference/ffd.py``), summed over the window's steps."""


def read(ctx):
    return ctx.check.get("cost_vs_ffd")
