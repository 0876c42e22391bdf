"""CUDA kernels launched a streaming tick or a decode request in the traced window."""

from benchmark.core.readers import per_call


def read(ctx):
    return per_call(ctx, len(ctx.trace.kernels()))
