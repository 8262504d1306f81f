"""argmin_roofline_pct.consolidate: the finalization kernel's share of its HBM
bound over the traced evaluations (``kernels/argmin.py``): the probe's K x B rows
and the exact what-ifs."""


def read(ctx):
    return ctx.roofline_pct("argmin")
