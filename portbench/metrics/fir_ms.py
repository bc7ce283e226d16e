"""fir_ms: device time of the FIRs (``dsp/fir.py``'s banded matmuls),
per recording: every device operation launched inside a span the
benchmark wraps around each ``dsp/fir._matmul`` call in the traced run,
traced to its launch by the profiler's correlation ids.  The device
codecs' GEMMs (the CRC and RS matmuls) launch outside it."""

from portbench.tracing import launched_within


def read(ctx):
    ops = launched_within(ctx.dev, ctx.host, "portbench.fir")
    ns = sum(e.end - e.start for e in ops)
    return 1e-6 * ns / ctx.n_recs if ns and ctx.n_recs else None
