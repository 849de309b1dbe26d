"""Set-up of the state and closures: the inputs, the program's config, its
slot binning and tables, its simulation closures and the kernel library."""


def read(ctx):
    return ctx.setup.get("state")
