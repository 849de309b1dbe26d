"""Set-up spent running dynamics: the equilibration steps and the warm-up."""


def read(ctx):
    return ctx.setup.get("equil")
