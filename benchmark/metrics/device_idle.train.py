"""The share of the traced window in which no kernel or copy ran on the
device (the union of the device intervals, not their sum), in %: the
busy time of the calls traced with device activity alone over the wall
of as many calls run unprofiled just before (``core/trace.py``), so the
profiler's cost to the host is not counted as idle."""


def read(ctx):
    w = ctx.trace.window_s
    return 100.0 * (1.0 - ctx.trace.busy_s / w) if w > 0 else None
