"""rs_launches_per_rec: CUDA kernels (not copies or sets) launched per
recording by the IL2P codec's Reed-Solomon decode (``ops/rs.rs_decode``):
those launched inside the port's ``pymodem.rs_decode`` ranges, traced to
their launch by the profiler's correlation ids."""

from portbench.tracing import is_copy, launched_within


def read(ctx):
    ops = launched_within(ctx.dev, ctx.host, "pymodem.rs_decode")
    n = sum(1 for e in ops if not is_copy(e.name))
    return n / ctx.n_recs if n and ctx.n_recs else None
