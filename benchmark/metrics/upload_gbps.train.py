"""Bytes a call copies off the host (the program's ``h2d_bytes`` counter)
over the device time of the host-to-device copies, in GB/s."""

from benchmark.core import spans


def read(ctx):
    return spans.upload_gbps(ctx)
