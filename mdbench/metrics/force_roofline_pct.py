"""The force pass's share of its roofline: the least time the card could
take for the passes the trace holds (the larger of operations over the float32
peak and bytes over the HBM peak, a pass's work counted at the traced state)
over the force kernels' measured time."""


def read(ctx):
    if not ctx.trace or not ctx.work or not ctx.peaks:
        return None
    passes, us = ctx.trace.layer_passes("force"), ctx.trace.layer_us("force")
    if not passes or us <= 0:
        return None
    ops, nbytes = ctx.work["force"]
    least_s = passes * max(ops / ctx.peaks["fp32_ops_per_s"], nbytes / ctx.peaks["bytes_per_s"])
    return 100.0 * least_s / (us / 1e6)
