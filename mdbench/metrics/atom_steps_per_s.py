"""Atoms x steps completed over the whole measured window's wall time."""


def read(ctx):
    if ctx.window is None or ctx.window["seconds"] <= 0:
        return None
    return ctx.window["atoms"] * ctx.window["steps"] / ctx.window["seconds"]
