"""Host wall time a step inside the runner's `emdee.runner.rollout` spans,
less the time inside CUDA API calls."""

from mdbench.lib.spans import host_dispatch_us_per_step


def read(ctx):
    return host_dispatch_us_per_step(ctx.trace)
