"""device_idle_pct: share of the traced window in which no kernel, copy or
set ran on the card."""


def read(ctx):
    if ctx.window_s <= 0 or not ctx.dev:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)
