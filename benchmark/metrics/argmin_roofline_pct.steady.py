"""argmin_roofline_pct.steady: the finalization kernel's share of its HBM bound
over the traced passes (``kernels/argmin.py``), at this cell's bin table."""


def read(ctx):
    return ctx.roofline_pct("argmin")
