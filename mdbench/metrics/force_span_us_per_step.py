"""Device time a step of the operations launched inside the program's
`emdee.force` spans: the force kernels and their wrappers' own work."""

from mdbench.lib.spans import span_us_per_step


def read(ctx):
    return span_us_per_step(ctx.trace, ("emdee.force",))
