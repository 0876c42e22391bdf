"""The share of its roofline reached by K1 (the fused log-mel frontend) in the training steps: the least time of the
work these calls need (``roofline/``) over the kernels' device time, in %."""

from benchmark.core.readers import roofline_share


def read(ctx):
    return roofline_share(ctx, ['k1'])
