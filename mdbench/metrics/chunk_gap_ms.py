"""Mean device idle time at a chunk boundary of the runner, from the trace."""


def read(ctx):
    gaps = ctx.trace.boundary_gaps_us() if ctx.trace else []
    return sum(gaps) / len(gaps) / 1e3 if gaps else None
