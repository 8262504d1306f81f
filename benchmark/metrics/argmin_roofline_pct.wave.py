"""argmin_roofline_pct.wave: the finalization kernel's share of its HBM bound over
the traced waves (``kernels/argmin.py``)."""


def read(ctx):
    return ctx.roofline_pct("argmin")
