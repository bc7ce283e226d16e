"""packet_build_ms: host time of the packet build
(``runtime/bank.packets_from_compact``), per recording: the port's own
``profiling`` stage ``packet_objects``, enabled in the traced run."""


def read(ctx):
    total = ctx.stages.get("packet_objects")
    return 1e3 * total / ctx.n_recs if total is not None and ctx.n_recs else None
