"""The share of its roofline reached by K4 (the exact prefix beam) in the decode requests or streaming ticks: the least time of the
work these calls need (``roofline/``) over the kernels' device time, in %."""

from benchmark.core.readers import roofline_share


def read(ctx):
    return roofline_share(ctx, ['k4'])
