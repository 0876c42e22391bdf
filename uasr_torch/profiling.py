"""Profiling, tracing and numeric-safety harnesses (counterpart of
``uasr.profiling``):

- ``StepTimer``: fenced per-step wall times with robust stats (median,
  p10, p90, and throughput as all payload over all time), the same
  ``stats()`` keys as the JAX package's; ``stop(*tensors)`` synchronises
  the CUDA device of each tensor given, the counterpart of
  ``block_until_ready``;
- ``span(name, device=False)`` and ``count(name, n)``: the program's own
  spans and counters, recorded only while a ``torch.profiler`` records
  (the one switch; otherwise a span is one check and a shared no-op
  context). A span opens a ``record_function`` range, so it lands in the
  profiler's trace on its clock, and appends a record (name, parent, the
  call it belongs to, start and end by ``time.time_ns()``, the clock of
  the profiler's host events) to an in-memory buffer that keeps the
  first ``CAP`` records; ``device=`` a CUDA device also times the span on
  that device's current stream with a pair of CUDA events. A count adds
  to the innermost open span's record and to a process total. Read with
  ``spans()`` and ``counters()``, cleared with ``reset()``;
- ``trace(logdir)``: ``torch.profiler`` over the enclosed code (CPU and,
  where a card is present, CUDA activities), written to ``logdir`` as a
  Chrome / Perfetto trace (``trace.json``; ui.perfetto.dev opens it) and
  the spans' summary (``spans.json``: per name the calls, host ms total
  and self, device ms; the counters);
- ``checked(fn)``: ``fn`` wrapped so that the first NaN or inf any op
  produces inside it raises, naming the op (a ``TorchDispatchMode`` that
  looks at every floating-point output); nothing is installed until the
  wrapper is called, so an unwrapped function pays nothing.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
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
            "throughput": float(payload_per_step * len(t) / t.sum()),
        }


# ------------------------------------------------------------ spans

CAP = 65536  # records the buffer keeps; later ones are dropped and counted
_enabled = torch.autograd._profiler_enabled
_OFF = contextlib.nullcontext()


class _Record:
    __slots__ = ("index", "name", "parent", "call", "depth", "start_ns", "end_ns", "events",
                 "device_ms", "counts")

    def __init__(self, index, name, parent, call, depth):
        self.index, self.name, self.parent, self.call, self.depth = (index, name, parent, call,
                                                                     depth)
        self.start_ns = self.end_ns = self.events = self.device_ms = self.counts = None


class _Buffer:
    """The records of the spans opened while a profiler recorded, each
    thread's stack of open spans, and the counters' totals (the lock keeps
    a record's index and the totals right when threads record at once)."""

    def __init__(self):
        self.records: list[_Record] = []
        self.dropped = 0
        self.totals: dict[str, int] = {}
        self.local = threading.local()
        self.lock = threading.Lock()

    def stack(self) -> list[_Record]:
        st = getattr(self.local, "stack", None)
        if st is None:
            st = self.local.stack = []
        return st

    def open(self, name: str) -> _Record:
        st = self.stack()
        parent = st[-1] if st else None
        with self.lock:
            recs = self.records
            if parent is not None and not (0 <= parent.index < len(recs)
                                           and recs[parent.index] is parent):
                parent = None  # opened before a reset
            i = len(recs) if len(recs) < CAP else -1
            if parent is None:
                rec = _Record(i, name, None, i, 0)
            else:
                rec = _Record(i, name, parent.index, parent.call, parent.depth + 1)
            if i < 0:
                self.dropped += 1
            else:
                recs.append(rec)
        st.append(rec)
        return rec

    def close(self, rec: _Record) -> None:
        st = self.stack()
        if st and st[-1] is rec:
            st.pop()

    def count(self, name: str, n: int) -> None:
        with self.lock:
            self.totals[name] = self.totals.get(name, 0) + int(n)
        st = self.stack()
        if st:
            c = st[-1].counts
            if c is None:
                c = st[-1].counts = {}
            c[name] = c.get(name, 0) + int(n)


_BUF = _Buffer()


class _Span:
    __slots__ = ("name", "stream", "rf", "rec")

    def __init__(self, name: str, stream):
        self.name, self.stream = name, stream

    # the record's interval holds the profiler's range: stamped just before
    # the range opens and after it closes
    def __enter__(self):
        self.rf = torch.profiler.record_function(self.name)
        t0 = time.time_ns()
        self.rf.__enter__()
        rec = self.rec = _BUF.open(self.name)
        rec.start_ns = t0
        if self.stream is not None and rec.index >= 0:
            rec.events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            rec.events[0].record(self.stream)
        return self

    def __exit__(self, *exc):
        rec = self.rec
        if rec.events is not None:
            rec.events[1].record(self.stream)
        _BUF.close(rec)
        self.rf.__exit__(*exc)
        rec.end_ns = time.time_ns()
        return False


def span(name: str, device=False):
    """A span of the program's own work, recorded only while a
    ``torch.profiler`` records and not while ``torch.export`` or the
    compiler traces; otherwise a shared no-op context. ``device``: the
    device the span's work runs on; a CUDA device's current stream also
    times the span with a pair of CUDA events, a CPU device nothing more."""
    if not _enabled() or torch.compiler.is_compiling():
        return _OFF
    stream = None
    if device is not False and torch.device(device).type == "cuda":
        stream = torch.cuda.current_stream(torch.device(device))
    return _Span(name, stream)


def count(name: str, n: int) -> None:
    """Add ``n`` to counter ``name`` (the innermost open span's and the
    total), under the same switch as ``span``."""
    if _enabled() and not torch.compiler.is_compiling():
        _BUF.count(name, n)


def spans() -> list[dict]:
    """The buffer's records in the order they were opened: ``name``,
    ``parent`` (a record's index, None at depth 0), ``call`` (the index of
    its depth-0 ancestor, its own at depth 0), ``depth``, ``start_ns`` and
    ``end_ns`` (``time.time_ns()``; end None while open), ``device_ms``
    (the CUDA event pair's, None without one) and ``counts``. Resolving
    the event pairs synchronises once."""
    recs = _BUF.records
    pending = [r for r in recs if r.events is not None and r.end_ns is not None]
    if pending:
        torch.cuda.synchronize()
        for r in pending:
            r.device_ms = float(r.events[0].elapsed_time(r.events[1]))
            r.events = None
    return [{"name": r.name, "parent": r.parent, "call": r.call, "depth": r.depth,
             "start_ns": r.start_ns, "end_ns": r.end_ns, "device_ms": r.device_ms,
             "counts": dict(r.counts or {})} for r in recs]


def counters() -> dict[str, int]:
    """Every counter's total since the last ``reset``."""
    return dict(_BUF.totals)


def reset() -> None:
    """Empty the buffer and the counters."""
    with _BUF.lock:
        _BUF.records = []
        _BUF.dropped = 0
        _BUF.totals = {}


def summary(records: list[dict]) -> dict:
    """Per span name: ``calls``, ``host_ms`` (the spans' durations),
    ``self_ms`` (each duration less what its children's intervals cover)
    and ``device_ms`` (the event pairs', None where no span of the name had
    one). Spans still open are left out."""
    kids: dict[int, list[tuple[int, int]]] = {}
    for r in records:
        if r["parent"] is not None and r["end_ns"] is not None:
            kids.setdefault(r["parent"], []).append((r["start_ns"], r["end_ns"]))
    out: dict[str, dict] = {}
    for i, r in enumerate(records):
        if r["end_ns"] is None:
            continue
        s, e = r["start_ns"], r["end_ns"]
        covered, reach = 0, s
        for a, b in sorted(kids.get(i, [])):
            a, b = max(a, reach), min(b, e)
            if b > a:
                covered += b - a
                reach = b
        d = out.setdefault(r["name"], {"calls": 0, "host_ms": 0.0, "self_ms": 0.0,
                                        "device_ms": None})
        d["calls"] += 1
        d["host_ms"] += (e - s) * 1e-6
        d["self_ms"] += max(e - s - covered, 0) * 1e-6
        if r["device_ms"] is not None:
            d["device_ms"] = (d["device_ms"] or 0.0) + r["device_ms"]
    return out


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a ``torch.profiler`` trace of the enclosed code into
    ``logdir/trace.json`` and its spans' summary into ``logdir/spans.json``
    (the buffer is reset on entry); yields the profiler
    (``key_averages()``)."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    reset()
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    with open(os.path.join(logdir, "spans.json"), "w") as f:
        json.dump({"spans": summary(spans()), "counters": counters(),
                   "dropped": _BUF.dropped}, f, indent=1)


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
