"""Streaming recognition on a fixed number of slots in one
``StreamingRecognizer``, driven as the serving daemon's engine drives it,
without the TCP front.

Every tick gives each streaming slot its utterance's next chunk of host
audio (a slot's first chunk also stamps its utterance length). A slot
whose utterance has had its last chunk is finished and reset in the next
tick (``masked_step_and_finish``, or ``masked_step`` when no slot
finishes) and takes the backlog's next utterance in the tick after. A
chunk's time runs from its tick's call to the tick's ids on the host.

For the check: every finished utterance's final transcript, and on the
ticks the seed samples (among the window's first ``within``), the window
features and logits of a few sampled slots, read by a forward hook from
the tick's first encoder call.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.core import files, weights
from benchmark.flops import enc_frames
from benchmark.loops.common import percentile, program_config


class Loop:
    kind = "stream"

    def __init__(self, conf: dict, work: dict, seed: int, device):
        self.conf, self.work, self.seed, self.dev = conf, work, int(seed), torch.device(device)

    def setup(self) -> None:
        from uasr_torch.models.models import build_model
        from uasr_torch.serve import StreamingRecognizer

        self.cfg = cfg = program_config(self.conf, self.seed)
        p = self.work["traffic"]
        self.backlog = files.module("traffic", p["kind"]).generate(p, self.seed)
        self.model = build_model(cfg.model, cfg.dim_output, cfg.frontend.dim_input,
                                 device=self.dev)
        shapes = {k: tuple(t.shape) for k, t in self.model.named_parameters()}
        self.w0 = weights.draw(shapes, self.seed, self.dev, self.conf["weights"])
        probe = range(min(32, len(self.backlog)))
        alen = torch.tensor([int(self.backlog.samples[u]) for u in probe], device=self.dev)
        audio = torch.zeros(len(alen), int(alen.max()), device=self.dev)
        for i in probe:
            audio[i, : alen[i]] = torch.as_tensor(self.backlog.audio(i), device=self.dev)
        weights.blank_bias(self.w0, self.conf, audio, alen)
        weights.load_into(self.model, self.w0)
        self.rec = StreamingRecognizer(cfg, self.model, device=self.dev)
        self.S = p["slots"]
        self.cs = self.rec.chunk_samples
        self.geom = (self.rec.chunk, self.rec.window, self.rec.subsample)
        self.state = self.rec.init(self.S)
        self.utt = np.arange(self.S)  # backlog position of each slot's utterance
        self.next_utt = self.S
        self.fed = np.zeros(self.S, np.int64)
        self.chunks = -(-self.backlog.samples // self.cs)
        self.audio = np.zeros((self.S, self.cs), np.float32)
        self.finals: dict = {}
        self.capture, self.seen = None, []
        self.model.register_forward_hook(self._hook)
        rng = np.random.default_rng(self.seed + 1)
        c = self.work["check"]
        self.sample_ticks = set(rng.choice(c["within"], c["ticks"], replace=False).tolist())
        self.sample_slots = rng.choice(self.S, c["slots"], replace=False)
        self.tick = 0
        for _ in range(self.work["warm_ticks"]):
            self._tick(record=False)
        self.tick = 0
        self.finals.clear()
        self.captured = []

    def _hook(self, module, inp, out):
        if self.capture is not None and not self.seen:
            s = torch.as_tensor(self.capture, device=inp[0].device)
            self.seen.append((inp[0][s].clone(), inp[1][s].clone(), out[0][s].clone()))

    def _region_frames(self, slots: np.ndarray, fed: np.ndarray) -> int:
        """Logit frames the beam has to advance over for ``slots`` whose
        last fed chunk is ``fed - 1``: the region one chunk behind it,
        within the utterance's valid frames."""
        B, model = self.backlog, self.conf["recipe"]["model"]
        fs = self.cfg.frontend.frame_shift
        vlog = enc_frames(-(-B.samples[self.utt[slots] % len(B)] // fs), model)
        per_chunk = int(enc_frames(self.rec.chunk, model))
        start = (fed - 2) * per_chunk
        return int(np.clip(vlog - start, 0, per_chunk)[fed >= 2].sum())

    def _tick(self, record: bool = True):
        S, B = self.cs, self.backlog
        streaming = self.fed < self.chunks[self.utt % len(B)]
        finishing = ~streaming
        stamp = streaming & (self.fed == 0)
        samples = B.samples[self.utt % len(B)]
        for s in np.flatnonzero(streaming):
            B.chunk_into(self.audio[s], int(self.utt[s] % len(B)), int(self.fed[s]))
        self.audio[finishing] = 0.0
        st, fi = np.flatnonzero(streaming), np.flatnonzero(finishing)
        meta = {"slots": self.S, "chunk_samples": S, "stepped": len(st), "finished": len(fi),
                "step_frames": self._region_frames(st, self.fed[st] + 1),
                "step_rows": int((self.fed[st] >= 1).sum()),
                "finish_frames": self._region_frames(fi, self.fed[fi] + 1),
                "valid_s": float(np.minimum(samples[st] - self.fed[st] * S, S).clip(min=0).sum())
                / self.cfg.frontend.sample_rate}
        sampled = record and self.tick in self.sample_ticks
        if sampled:
            slots = [int(s) for s in self.sample_slots if streaming[s]]
            info = [(s, int(self.utt[s]), int(self.fed[s])) for s in slots]
            self.capture, self.seen = slots or None, []
        t0 = time.perf_counter()
        if len(fi):
            self.state, out, fout = self.rec.masked_step_and_finish(
                self.state, self.audio, streaming, finishing, stamp, samples)
            fout = fout.cpu().numpy()
        else:
            self.state, out = self.rec.masked_step(self.state, self.audio, streaming, stamp,
                                                   samples, packed=True)
        out = out.cpu().numpy()
        dt = time.perf_counter() - t0
        if sampled and self.seen:
            self.captured.append((info, self.seen[0]))
        self.capture = None
        for s in fi:
            if record:
                self.finals[int(self.utt[s])] = fout[s, : fout[s, -1]].tolist()
            self.utt[s], self.fed[s] = self.next_utt, 0
            self.next_utt += 1
        self.fed[st] += 1
        self.tick += 1
        return dt, meta

    def run(self, seconds: float | None = None, calls: int | None = None) -> dict:
        lat, done = [], []
        t0 = time.perf_counter()
        while True:
            dt, meta = self._tick()
            lat.append(dt * 1e3)
            done.append(meta)
            if calls is not None and len(done) >= calls:
                break
            if calls is None and time.perf_counter() - t0 >= seconds:
                break
        wall = time.perf_counter() - t0
        n = [m["stepped"] for m in done]
        audio = sum(m["valid_s"] for m in done)
        chunk_ms = np.repeat(lat, n)
        return {"wall_s": wall, "calls": done, "attempted": int(sum(n)), "failed": 0,
                "e2e": {"serve_audio_s_per_s": audio / wall,
                        "chunk_p95_ms": percentile(chunk_ms, 95)},
                "notes": f"{len(done)} ticks, {int(sum(n))} chunks, {audio:.1f} audio-s in "
                         f"{wall:.3f} s, chunk p50 {percentile(chunk_ms, 50):.3f} ms p95 "
                         f"{percentile(chunk_ms, 95):.3f} ms, {self._tokens():.1f} tokens a final"}

    def _tokens(self) -> float:
        return sum(map(len, self.finals.values())) / max(len(self.finals), 1)

    def release(self) -> None:
        self.model = self.rec = self.state = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
