"""validate_ms: host time of the aggregate's validation (CRC and header
of every packet, ``packets.PacketAggregate.validate_all``), mean per
recording: the port's own ``profiling`` stage ``aggregate_validate``
inside ``runtime/bank._finish_plan``, enabled in the traced run."""


def read(ctx):
    total = ctx.stages.get("aggregate_validate")
    return 1e3 * total / ctx.n_recs if total is not None and ctx.n_recs else None
