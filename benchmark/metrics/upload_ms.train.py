"""Device time of host-to-device copies a training step (the batch's upload)."""

from benchmark.core.readers import per_call


def read(ctx):
    return per_call(ctx, 1e3 * ctx.trace.copies_s('HtoD'))
