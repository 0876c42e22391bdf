"""The share of its roofline reached by K2 and K2-bwd (the three BiGRU layers' recurrences, forward and backward) in the training steps: the least time of the
work these calls need (``roofline/``) over the kernels' device time, in %."""

from benchmark.core.readers import roofline_share


def read(ctx):
    return roofline_share(ctx, ['k2', 'k2_bwd'])
