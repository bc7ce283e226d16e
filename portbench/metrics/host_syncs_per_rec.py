"""host_syncs_per_rec: times per recording the port's host blocked on a
device result (a readback of the sizing statistics or of the packed
codec output, the byte streams for the host FSM): the port's own
``profiling`` counter of ``host_wait`` stages, enabled in the traced run.
With the codec's budgets cached it is one per codec sub-group; a budget
miss, a compaction redo or an escalation adds to it."""

from pymodem_tpu_torch import profiling


def read(ctx):
    n = profiling.counts().get("host_wait")
    return n / ctx.n_recs if n and ctx.n_recs else None
