"""Device operations launched a step over the traced window."""


def read(ctx):
    if not ctx.trace or not ctx.trace.ops:
        return None
    return len(ctx.trace.ops) / ctx.trace.steps
