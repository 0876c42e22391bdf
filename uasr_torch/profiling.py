"""Profiling, tracing and numeric-safety harnesses (counterpart of
``uasr.profiling``):

- ``StepTimer``: fenced per-step wall times with robust stats (median,
  p10, p90, throughput), the same ``stats()`` keys as the JAX package's;
  ``stop(*tensors)`` synchronises the CUDA device of each tensor given,
  the counterpart of ``block_until_ready``;
- ``trace(logdir)``: ``torch.profiler`` over the enclosed code (CPU and,
  where a card is present, CUDA activities), written to ``logdir`` as a
  Chrome / Perfetto trace (``trace.json``; ui.perfetto.dev opens it);
- ``checked(fn)``: ``fn`` wrapped so that the first NaN or inf any op
  produces inside it raises, naming the op (a ``TorchDispatchMode`` that
  looks at every floating-point output); nothing is installed until the
  wrapper is called, so an unwrapped function pays nothing.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten


class StepTimer:
    """Collects fenced per-step wall times; reports robust stats."""

    def __init__(self):
        self.times: list[float] = []
        self._t0: float | None = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, *fence):
        for x in fence:
            if isinstance(x, torch.Tensor) and x.is_cuda:
                torch.cuda.synchronize(x.device)
        self.times.append(time.perf_counter() - self._t0)

    @contextlib.contextmanager
    def step(self):
        """Time the enclosed step; tensors put into the yielded dict are
        fenced on."""
        self.start()
        out: dict = {}
        yield out
        self.stop(*out.values())

    def stats(self, payload_per_step: float = 1.0) -> dict:
        t = np.asarray(self.times)
        if len(t) == 0:
            return {}
        return {
            "steps": len(t),
            "median_s": float(np.median(t)),
            "p10_s": float(np.percentile(t, 10)),
            "p90_s": float(np.percentile(t, 90)),
            "throughput": float(payload_per_step / np.median(t)),
        }


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a ``torch.profiler`` trace of the enclosed code into
    ``logdir/trace.json``; yields the profiler (``key_averages()``)."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class NonFiniteError(FloatingPointError):
    """An op inside a ``checked`` function produced a NaN or inf."""


class _NonFiniteCheck(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            if (isinstance(t, torch.Tensor) and t.is_floating_point() and t.numel()
                    and not bool(torch.isfinite(t).all())):
                raise NonFiniteError(f"{func} produced a non-finite value "
                                     f"(shape {tuple(t.shape)}, dtype {t.dtype})")
        return out


def checked(fn: Callable) -> Callable:
    """``fn`` that raises ``NonFiniteError`` on the first NaN or inf an op
    produces inside it, naming the op."""

    def wrapper(*args, **kwargs):
        with _NonFiniteCheck():
            return fn(*args, **kwargs)

    return wrapper
