"""Device time a step of the operations no layer file claims: the rollout's
eager integrator and thermostat ops and whatever else is unnamed."""

from mdbench.lib.trace import UNMATCHED


def read(ctx):
    if not ctx.trace:
        return None
    us = ctx.trace.layer_us(UNMATCHED)
    return us / ctx.trace.steps if us > 0 else None
