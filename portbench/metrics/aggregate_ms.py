"""aggregate_ms: host time of the plan runner's aggregate
(``runtime/bank._finish_plan``: validate, cross-chain correlate, render
the reports, ``packets.PacketAggregate``), mean per recording: a span the
benchmark wraps around each call in the traced run."""


def read(ctx):
    spans = ctx.spans.get("finish_plan")
    return 1e3 * sum(spans) / len(spans) if spans else None
