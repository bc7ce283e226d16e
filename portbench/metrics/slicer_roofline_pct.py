"""slicer_roofline_pct: kernel K1's share of its memory roofline: the
least time the card's HBM needs for the bytes the traffic requires
(``roofline/binary_slicer.py``) over K1's summed device time in the
traced window."""

from portbench.roofline import binary_slicer


def read(ctx):
    return ctx.roofline(binary_slicer)
