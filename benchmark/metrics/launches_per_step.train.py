"""CUDA kernels launched a training step in the traced window (the device trace's kernels over the steps)."""

from benchmark.core.readers import per_call


def read(ctx):
    return per_call(ctx, len(ctx.trace.kernels()))
