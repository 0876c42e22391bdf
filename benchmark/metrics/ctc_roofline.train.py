"""The share of its roofline reached by K3 and K3-bwd (the CTC loss's forward and backward recursions) in the training steps: the least time of the
work these calls need (``roofline/``) over the kernels' device time, in %."""

from benchmark.core.readers import roofline_share


def read(ctx):
    return roofline_share(ctx, ['k3', 'k3_bwd'])
