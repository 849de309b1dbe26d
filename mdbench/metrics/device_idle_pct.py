"""Share of the traced window's wall time in which no operation ran on the
device."""


def read(ctx):
    if not ctx.trace or ctx.trace.window_s <= 0 or not ctx.trace.ops:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
