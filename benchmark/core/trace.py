"""The traced window: ``torch.profiler`` over a bounded run of calls, and
what the readers take from its device timeline.

Device events are CUDA kernels and the copies and sets (``Memcpy ...``,
``Memset ...``). Busy time is the union of the device intervals in the
window, not their sum. A trace is taken in one of two ways:

- with device activity alone: the profiler records no host operation,
  but CUPTI's records of each launch still slow the host (by 5 to 11 % a
  training step and a decode request on an H100), so the window
  (``wall_s``) is the same number of calls run without the profiler just
  before, by the host clock from a synchronise before the first call to
  one after the last. Busy and idle time and every per-layer metric come
  from this pass;
- with host and device activity: the window is the benchmark's own
  ``bench.window`` span, which ends after a synchronise, so every device
  event of its calls lies inside it. Recording every host operation
  stretches the host's time, so this pass gives only the breakdown's idle
  gaps, named by what the host was doing in each.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

WINDOW = "bench.window"


def _is_copy(name: str) -> bool:
    return name.startswith("Memcpy") or name.startswith("Memset")


class Trace:
    def __init__(self, prof, wall_s: float | None = None):
        from torch.autograd import DeviceType

        self.dev, self.cpu = [], []
        self.window = None
        events = prof.profiler.kineto_results.events()
        for e in events:
            if e.device_type() != DeviceType.CUDA:
                name, s = e.name(), e.start_ns()
                if name == WINDOW:
                    self.window = (s, s + e.duration_ns())
                self.cpu.append((name, s, s + e.duration_ns()))
        # a host annotation also appears on the device's timeline under its
        # own name; it is no device work
        host_names = {c[0] for c in self.cpu}
        for e in events:
            if e.device_type() == DeviceType.CUDA and e.name() not in host_names:
                s = e.start_ns()
                self.dev.append((e.name(), s, s + e.duration_ns()))
        self.wall_s = wall_s
        if wall_s is not None:
            self.dev.sort(key=lambda d: d[1])
            return
        if self.window is None:
            raise RuntimeError(f"the trace has no {WINDOW} span")
        w0, w1 = self.window
        self.dev = sorted(((n, max(s, w0), min(e, w1)) for n, s, e in self.dev
                           if e > w0 and s < w1), key=lambda d: d[1])

    @property
    def window_s(self) -> float:
        if self.wall_s is not None:
            return self.wall_s
        return (self.window[1] - self.window[0]) * 1e-9

    def merged(self) -> list[tuple[int, int]]:
        out: list[list[int]] = []
        for _, s, e in self.dev:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.merged()) * 1e-9

    def kernels(self) -> list[tuple[str, int, int]]:
        return [d for d in self.dev if not _is_copy(d[0])]

    def seconds_of(self, symbols) -> float:
        """Device seconds of the kernels whose names hold one of ``symbols``."""
        return sum(e - s for n, s, e in self.kernels() if any(k in n for k in symbols)) * 1e-9

    def copies_s(self, kind: str) -> float:
        """Device seconds of the copies of one kind (``HtoD``, ``DtoH``)."""
        return sum(e - s for n, s, e in self.dev if n.startswith("Memcpy") and kind in n) * 1e-9

    def device_ops(self, top: int = 10) -> list:
        by: dict = defaultdict(int)
        for n, s, e in self.dev:
            by[n[:160]] += e - s
        return [[n, t * 1e-9] for n, t in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> list:
        """Idle device time in the window by what the host was doing: the
        innermost host event at each gap's middle (a trace with host
        activity)."""
        cpu = sorted(c for c in self.cpu if c[0] != WINDOW)
        cpu.sort(key=lambda c: c[1])
        starts = [c[1] for c in cpu]
        by: dict = defaultdict(int)
        edges = [self.window[0]] + [x for iv in self.merged() for x in iv] + [self.window[1]]
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            mid = (a + b) // 2
            what = "host outside any traced call"
            i = bisect.bisect_right(starts, mid) - 1
            for j in range(i, max(i - 20000, -1), -1):
                if cpu[j][2] >= mid:
                    what = cpu[j][0]
                    break
            by[what[:160]] += b - a
        return [[n, t * 1e-9] for n, t in sorted(by.items(), key=lambda kv: -kv[1])[:top]]
