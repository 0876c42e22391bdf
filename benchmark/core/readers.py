"""What the per-layer metric readers share. A reader gets a ``Context``
and returns a number, or None when it finds nothing to read (the metric
is then left out of the result line)."""

from __future__ import annotations

from dataclasses import dataclass, field

from benchmark.core import files


@dataclass
class Context:
    trace: object  # core.trace.Trace of the profiled calls
    calls: list  # the profiled calls' shapes
    plain: dict  # the unprofiled run: wall_s and calls
    conf: dict  # the configuration file
    loop: str  # the cell's loop: train, decode, stream
    peaks: dict = field(default_factory=files.peaks)


def per_call(ctx: Context, value: float | None) -> float | None:
    return None if value is None or not ctx.calls else value / len(ctx.calls)


def roofline_share(ctx: Context, kernels: list[str]) -> float | None:
    """The kernels' least time over their device time in the profiled
    calls, in %: None where no call needs them or none of them ran."""
    mods = [files.module("roofline", k) for k in kernels]
    need = sum(m.bound_s(c, ctx.conf, ctx.peaks) for m in mods for c in ctx.calls
               if ctx.loop in m.LOOPS)
    symbols = sorted({s for m in mods if ctx.loop in m.LOOPS for s in m.SYMBOLS})
    took = ctx.trace.seconds_of(symbols) if symbols else 0.0
    if need <= 0 or took <= 0:
        return None
    return 100.0 * need / took


def mfu(ctx: Context) -> float | None:
    """Model FLOPs of the unprofiled run's calls over its wall and the
    configuration's peak, in %."""
    model = ctx.conf["recipe"]["model"]
    f = files.module("flops", model["encoder"])
    total = sum(f.call_flops(c, ctx.conf, ctx.loop) for c in ctx.plain["calls"])
    dtype = model.get("dtype", "float32")
    if total <= 0:
        return None
    return 100.0 * total / (ctx.plain["wall_s"] * ctx.peaks["flops"][dtype])
