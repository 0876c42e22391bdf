"""The share of its roofline reached by K1 in a decode request or K7 in a streaming tick: the least time of the
work these calls need (``roofline/``) over the kernels' device time, in %."""

from benchmark.core.readers import roofline_share


def read(ctx):
    return roofline_share(ctx, ['k1', 'k7'])
