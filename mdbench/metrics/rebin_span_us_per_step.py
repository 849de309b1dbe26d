"""Device time a step of the operations launched inside the program's
`emdee.rebin` spans: on the sort rebin its sort and its gathers alike."""

from mdbench.lib.spans import span_us_per_step


def read(ctx):
    return span_us_per_step(ctx.trace, ("emdee.rebin",))
