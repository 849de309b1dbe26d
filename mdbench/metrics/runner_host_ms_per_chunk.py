"""Host wall time a chunk in the runner's spans other than the rollout and
the wait for the device: the energy pass's enqueue, the guards, dumps and
checkpoints."""

from mdbench.lib.spans import runner_host_ms_per_chunk


def read(ctx):
    return runner_host_ms_per_chunk(ctx.trace)
