"""Device ms a tick of the streaming finish pass (the ``stream.finish``
span's CUDA event pair, over every tick traced, finishing or not)."""

from benchmark.core import spans


def read(ctx):
    return spans.device_ms(ctx, "stream.finish")
