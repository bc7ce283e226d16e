"""loop_roofline_pct: kernel K2's share of its memory roofline
(``roofline/coherent_loop.py``), as ``slicer_roofline_pct`` for K1."""

from portbench.roofline import coherent_loop


def read(ctx):
    return ctx.roofline(coherent_loop)
