"""The readers of the program's spans and counters (``core/spans.py`` and
the metrics that call it) on a synthetic ``Context`` and buffer with known
intervals, a program without spans, and a CPU rehearsal of each small cell
with ``--trace 1`` reporting ``host_ms.*``."""

from __future__ import annotations

import pytest

from benchmark.core import files, spans
from benchmark.core.readers import Context
from benchmark.tests import tiny

MS = 1_000_000  # ns


class FakeTrace:
    def __init__(self, busy, htod_s=0.0):
        self.busy, self.htod_s = busy, htod_s

    def merged(self):
        return list(self.busy)

    def copies_s(self, kind):
        return self.htod_s if kind == "HtoD" else 0.0


def _rec(name, parent, call, depth, s, e, device_ms=None, counts=None):
    return {"name": name, "parent": parent, "call": call, "depth": depth, "start_ns": s,
            "end_ns": e, "device_ms": device_ms, "counts": counts or {}}


def _buffer():
    """Two stream ticks (0-10 ms and 20-30 ms) of the device-only pass,
    then a third that the host-activity pass recorded."""
    recs = []
    for k, t in enumerate((0, 20, 100)):
        i = len(recs)
        recs += [_rec("stream.tick", None, i, 0, t * MS, (t + 10) * MS),
                 _rec("stream.upload", i, i, 1, t * MS, (t + 1) * MS,
                      counts={"h2d_bytes": 1_000_000}),
                 _rec("stream.finish", i, i, 1, (t + 5) * MS, (t + 9) * MS, device_ms=2.5 + k)]
    return recs


@pytest.fixture
def ctx(monkeypatch):
    from uasr_torch import profiling

    monkeypatch.setattr(profiling, "spans", _buffer)
    # busy 2-4, 8-12 and 22-35 ms: idle 0-2, 4-8, 12-22 ms
    trace = FakeTrace([(2 * MS, 4 * MS), (8 * MS, 12 * MS), (22 * MS, 35 * MS)], htod_s=1e-3)
    return Context(trace, [{}, {}], {}, {}, "stream", peaks={})


def _read(name, ctx):
    return files.module("metrics", name).read(ctx)


def test_readers_on_known_intervals(ctx):
    assert [c[0]["start_ns"] for c in spans.calls(ctx)] == [0, 20 * MS]  # the first two ticks
    assert _read("host_ms.serve", ctx) == pytest.approx(10.0)
    # idle inside the ticks: 0-2 and 4-8 of the first, 20-22 of the second; 10-12 and
    # 12-20 are the caller's
    assert _read("program_idle_ms.serve", ctx) == pytest.approx((2 + 4 + 2) / 2)
    assert _read("finish_ms.serve", ctx) == pytest.approx((2.5 + 3.5) / 2)
    # 2 MB over 1 ms of copies
    assert _read("upload_gbps.serve", ctx) == pytest.approx(2.0)
    assert _read("optimizer_ms.train", ctx) is None  # no such span in these calls


def test_other_loops_and_empty_traces(ctx, monkeypatch):
    ctx.loop = "train"  # no train.step in the buffer
    assert _read("host_ms.train", ctx) is None and _read("upload_gbps.train", ctx) is None
    ctx.loop = "stream"
    ctx.trace = FakeTrace([])
    assert _read("program_idle_ms.serve", ctx) is None and _read("upload_gbps.serve", ctx) is None
    # records all after the device trace (the host-activity pass's): nothing to intersect
    ctx.trace = FakeTrace([(-30 * MS, -20 * MS)])
    assert _read("program_idle_ms.serve", ctx) is None


def test_a_program_without_spans_gives_nothing(ctx, monkeypatch):
    from uasr_torch import profiling

    monkeypatch.delattr(profiling, "spans")
    for name in ("host_ms.serve", "program_idle_ms.serve", "finish_ms.serve",
                 "upload_gbps.serve"):
        assert _read(name, ctx) is None


@pytest.mark.parametrize("cell,metric", [("tiny_libri.train_bucketed", "host_ms.train"),
                                         ("tiny_ais.stream_256", "host_ms.serve"),
                                         ("tiny_libri.decode_64", "host_ms.serve")])
def test_a_traced_rehearsal_reports_host_ms(tmp_path, cell, metric):
    copy = tiny.make_copy(tmp_path)
    out = tiny.result(tiny.run(copy, tiny.rehearse(cell, trace=1)))
    assert out["correct"] and out["metrics"][metric]["value"] > 0
