"""Device ms a step of ``ClipAdam``'s update and its application (the
``train.optimizer`` span's CUDA event pair)."""

from benchmark.core import spans


def read(ctx):
    return spans.device_ms(ctx, "train.optimizer")
