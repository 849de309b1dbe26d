"""Device time a step of the force pass's kernels."""


def read(ctx):
    if not ctx.trace:
        return None
    us = ctx.trace.layer_us("force")
    return us / ctx.trace.steps if us > 0 else None
