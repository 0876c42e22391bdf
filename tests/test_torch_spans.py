"""The port's spans and counters (``uasr_torch.profiling.span`` / ``count``):
nothing recorded and no ``record_function`` entered without a profiler;
under a CPU ``torch.profiler`` each span's kineto event beside its record
(the same clock), parents, call ids and counters; the span trees of one
``CTCTrainer.train_step``, one streaming tick and one ``run_inference``
request on tiny CPU configurations; ``profiling.trace``'s ``spans.json``;
and no profiler op in a program ``torch.export`` traces under a profiler."""

import dataclasses
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from uasr_torch import profiling
from uasr_torch.config import load_config
from uasr_torch.frontend.features import frontend_state_from_config
from uasr_torch.infer import run_inference
from uasr_torch.serve import StreamingRecognizer
from uasr_torch.train import CTCTrainer, _to_device
from uasr_torch.vocab import Vocab

B, L, U = 2, 4000, 5


@pytest.fixture(autouse=True)
def _one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    profiling.reset()
    yield
    profiling.reset()
    torch.set_num_threads(saved)


def _cfg(**frontend):
    cfg = load_config("configs/synthetic_smoke.yaml")
    fe = dataclasses.replace(cfg.frontend, **frontend)
    model = dataclasses.replace(cfg.model, hidden_size=16)
    return cfg.replace(frontend=fe, model=model,
                       ctc=dataclasses.replace(cfg.ctc, use_beam=True, beam_width=2))


def _batch():
    rng = np.random.RandomState(0)
    audio = (0.1 * rng.randn(B, L)).astype(np.float32)
    labels = rng.randint(1, 9, (B, U)).astype(np.int32)
    return audio, np.array([L, L // 2], np.int32), labels, np.array([U, 3], np.int32)


def _tree(recs, i=None):
    """(name, [children's trees]) of record ``i``'s subtree, or the list of
    every depth-0 record's tree."""
    if i is None:
        return [_tree(recs, j) for j, r in enumerate(recs) if r["parent"] is None]
    return (recs[i]["name"], [_tree(recs, j) for j, r in enumerate(recs) if r["parent"] == i])


def _recorded(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return prof, profiling.spans()


def test_off_records_nothing_and_enters_no_range(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    assert profiling.span("a") is profiling.span("b", device="cpu")  # one shared no-op
    for _ in range(3):
        with profiling.span("a"):
            with profiling.span("b", device="cpu"):
                profiling.count("n", 5)
    assert profiling.spans() == [] and profiling.counters() == {}


def test_spans_on_the_profiler_clock_with_parents_calls_and_counters():
    def work():
        for _ in range(2):
            with profiling.span("call"):
                profiling.count("bytes", 3)
                with profiling.span("inner", device=torch.device("cpu")):
                    torch.ones(8, 8).sum()
                    profiling.count("bytes", 4)
                with profiling.span("other"):
                    profiling.count("rows", 2)

    prof, recs = _recorded(work)
    assert [r["name"] for r in recs] == ["call", "inner", "other"] * 2
    assert [r["parent"] for r in recs] == [None, 0, 0, None, 3, 3]
    assert [r["call"] for r in recs] == [0, 0, 0, 3, 3, 3]
    assert [r["depth"] for r in recs] == [0, 1, 1] * 2
    assert recs[0]["counts"] == {"bytes": 3} and recs[1]["counts"] == {"bytes": 4}
    assert recs[2]["counts"] == {"rows": 2}
    assert profiling.counters() == {"bytes": 14, "rows": 4}
    assert all(r["device_ms"] is None for r in recs)  # a CPU device: no event pair
    kineto = {}
    for e in prof.profiler.kineto_results.events():
        kineto.setdefault(e.name(), []).append(e.start_ns())
    for name in ("call", "inner", "other"):
        mine = [r["start_ns"] for r in recs if r["name"] == name]
        assert len(kineto[name]) == len(mine)
        for k, b in zip(sorted(kineto[name]), mine):
            assert abs(b - k) < 1_000_000, (name, b - k)
    for r in recs:
        assert r["start_ns"] <= r["end_ns"]


def test_buffer_keeps_the_first_records(monkeypatch):
    monkeypatch.setattr(profiling, "CAP", 4)

    def work():
        for _ in range(3):
            with profiling.span("call"), profiling.span("inner"):
                profiling.count("n", 1)

    _, recs = _recorded(work)
    assert [r["name"] for r in recs] == ["call", "inner"] * 2
    assert profiling._BUF.dropped == 2 and profiling.counters() == {"n": 3}


def test_threads_recording_at_once_lose_nothing():
    """The buffer's shared state under threads that record at once (the
    profiler's switch is per thread, so its records are driven directly)."""
    import sys
    import threading

    buf = profiling._BUF

    def worker(k):
        for _ in range(200):
            outer = buf.open(f"outer{k}")
            inner = buf.open(f"inner{k}")
            buf.count("n", 1)
            buf.close(inner)
            buf.close(outer)

    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=worker, args=(k,)) for k in range(16)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(saved)
    recs = buf.records
    assert len(recs) == 6400 and profiling.counters() == {"n": 3200}
    for i, r in enumerate(recs):
        assert r.index == i
        if r.name.startswith("inner"):
            p = recs[r.parent]
            assert p.name == "outer" + r.name[5:] and r.call == r.parent and r.counts == {"n": 1}
        else:
            assert r.parent is None and r.call == i and r.counts is None


def test_h2d_bytes_count_what_leaves_the_host():
    batch = _batch()
    _, _ = _recorded(lambda: _to_device(batch, "cpu"))
    assert profiling.counters() == {}  # nothing leaves the host
    _, _ = _recorded(lambda: _to_device(batch, torch.device("meta")))
    want = batch[0].nbytes + sum(x.size * 8 for x in batch[1:])  # the rest as int64
    assert profiling.counters() == {"h2d_bytes": want}


def test_train_step_span_tree():
    trainer = CTCTrainer(_cfg(), device="cpu")
    state = trainer.init_state()
    _, recs = _recorded(lambda: trainer.train_step(state, _batch()))
    assert _tree(recs) == [("train.step", [
        ("train.upload", []), ("train.frontend", []), ("train.forward", []),
        ("train.loss", []), ("train.backward", []), ("train.optimizer", [])])]


def _recognizer(encoder="cnn"):
    cfg = _cfg(cmvn="streaming", streaming_chunk_frames=32)
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, encoder=encoder))
    trainer = CTCTrainer(cfg, device="cpu")
    return StreamingRecognizer(cfg, trainer.model, device="cpu")


# the window encoder re-decodes its last region at the finish; uni_gru has
# decoded every chunk on arrival and reads the best beam out
FINISH = {"cnn": [("stream.encoder", []), ("stream.beam", [])], "uni_gru": []}


@pytest.mark.parametrize("encoder", sorted(FINISH))
def test_streaming_tick_span_trees(encoder):
    rec = _recognizer(encoder)
    st = rec.init(B)
    cs = rec.chunk_samples
    audio = (0.1 * np.random.RandomState(1).randn(B, cs)).astype(np.float32)
    on, off = np.array([True, False]), np.array([False, True])
    samples = np.array([3 * cs, cs])

    def tick():
        s, _, _ = rec.masked_step(st, audio, on, on, samples)
        rec.masked_step_and_finish(s, audio, on, off, on, samples)

    _, recs = _recorded(tick)
    step = [("stream.upload", []), ("stream.frontend", []), ("stream.encoder", []),
            ("stream.beam", [])]
    assert _tree(recs) == [("stream.tick", step + [("stream.readback", [])]),
                           ("stream.tick", step + [("stream.finish", FINISH[encoder])])]


def test_run_inference_span_tree(tmp_path):
    cfg = _cfg()
    model = CTCTrainer(cfg, device="cpu").model
    fstate = frontend_state_from_config(cfg.frontend, device="cpu")
    vocab = Vocab(tokens=[f"t{i}" for i in range(cfg.dim_output)], blank_id=0)
    _, recs = _recorded(lambda: run_inference(cfg, model, fstate, [_batch(), _batch()],
                                              vocab=vocab, hyp_path=str(tmp_path / "h.txt"),
                                              device="cpu"))
    request = ("infer.request", [
        ("infer.upload", []), ("infer.frontend", []), ("infer.encoder", []),
        ("infer.beam", []), ("infer.score", []), ("infer.readback", []), ("infer.write", [])])
    assert _tree(recs) == [request, request]
    assert {r["call"] for r in recs} == {0, len(recs) // 2}


def test_trace_writes_spans_json_with_nonnegative_self_times(tmp_path):
    with profiling.span("before"):  # no profiler: not recorded
        pass
    with profiling.trace(str(tmp_path / "prof")):
        for _ in range(3):
            with profiling.span("call"):
                with profiling.span("a"):
                    torch.ones(16, 16) @ torch.ones(16, 16)
                with profiling.span("b"):
                    profiling.count("n", 2)
    out = json.loads((tmp_path / "prof" / "spans.json").read_text())
    assert set(out["spans"]) == {"call", "a", "b"} and out["counters"] == {"n": 6}
    for name, d in out["spans"].items():
        assert d["calls"] == 3 and d["self_ms"] >= 0 and d["host_ms"] >= d["self_ms"]
        assert d["device_ms"] is None
    call = out["spans"]["call"]
    assert call["self_ms"] <= call["host_ms"] - out["spans"]["a"]["host_ms"] + 1e-6
    assert (tmp_path / "prof" / "trace.json").exists() and out["dropped"] == 0


def test_export_under_a_profiler_holds_no_profiler_op():
    from uasr_torch.tools import export

    rec = _recognizer()
    step, _finish, flat0, _ = export.stream_programs(rec, B)
    with profile(activities=[ProfilerActivity.CPU]), torch.no_grad():
        ep = torch.export.export(step, (flat0, torch.zeros(B, rec.chunk_samples)))
    targets = [str(n.target) for n in ep.graph.nodes if n.op == "call_function"]
    assert targets and not [t for t in targets if "profiler" in t or "record_function" in t]
    assert profiling.spans() == []
