"""The share of its roofline reached by K2 (the three BiGRU layers' forward recurrences) in the decode requests: the least time of the
work these calls need (``roofline/``) over the kernels' device time, in %."""

from benchmark.core.readers import roofline_share


def read(ctx):
    return roofline_share(ctx, ['k2'])
