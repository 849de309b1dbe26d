"""Process start to the first timed step: imports, the kernel library,
inputs, state, equilibration and warm-up."""


def read(ctx):
    return ctx.setup.get("total")
