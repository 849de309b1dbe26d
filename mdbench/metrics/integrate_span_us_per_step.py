"""Device time a step of the operations launched inside the program's
`emdee.integrate` and `emdee.thermostat` spans: drift, kicks, the
staleness check and the thermostat."""

from mdbench.lib.spans import span_us_per_step


def read(ctx):
    return span_us_per_step(ctx.trace, ("emdee.integrate", "emdee.thermostat"))
