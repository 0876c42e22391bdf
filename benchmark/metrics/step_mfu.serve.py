"""Model FLOPs of a streaming tick or a decode request (``flops/``) over its wall time and the
configuration dtype's peak, in %, from the run's unprofiled phase."""

from benchmark.core.readers import mfu


def read(ctx):
    return mfu(ctx)
