"""Batch transcription: ``uasr_torch.infer.run_inference`` on one request
at a time, each a bucketed batch of host audio; the transcript is the
hypothesis file the call writes (under ``TMPDIR``), read back and removed.

A request's time runs from the call to its transcript on the host. A
forward hook on the model keeps the frontend's output and the logits of
the requests the check samples (drawn from the seed among the window's
first ``check_within`` requests, one of them of the longest bucket).
"""

from __future__ import annotations

import os
import tempfile
import time

import numpy as np
import torch

from benchmark.core import files, weights
from benchmark.loops.common import batch_meta, percentile, program_config


class Loop:
    kind = "decode"

    def __init__(self, conf: dict, work: dict, seed: int, device):
        self.conf, self.work, self.seed, self.dev = conf, work, int(seed), torch.device(device)

    def setup(self) -> None:
        from uasr_torch.frontend.features import frontend_state_from_config
        from uasr_torch.models.models import build_model
        from uasr_torch.vocab import Vocab

        self.cfg = cfg = program_config(self.conf, self.seed)
        gen = files.module("traffic", self.work["traffic"]["kind"])
        self.pool = gen.generate(self.work["traffic"], self.seed)
        self.metas = [batch_meta(b, self.conf) for b in self.pool]
        self.model = build_model(cfg.model, cfg.dim_output, cfg.frontend.dim_input,
                                 device=self.dev)
        shapes = {k: tuple(p.shape) for k, p in self.model.named_parameters()}
        self.w0 = weights.draw(shapes, self.seed, self.dev, self.conf["weights"])
        audio, alen = (torch.as_tensor(x, device=self.dev) for x in self.pool[0][:2])
        weights.blank_bias(self.w0, self.conf, audio, alen.long())
        weights.load_into(self.model, self.w0)
        self.fstate = frontend_state_from_config(cfg.frontend, device=self.dev)
        self.vocab = Vocab(tokens=list(self.conf["vocab_tokens"]), blank_id=cfg.ctc.blank_id)
        self.ids = {t: i for i, t in enumerate(self.conf["vocab_tokens"])}
        self.tmp = tempfile.mkdtemp(prefix="bench-decode-")
        self.hyp = os.path.join(self.tmp, "hyp.txt")
        self.capture, self.seen = False, []
        self.model.register_forward_hook(self._hook)
        rng = np.random.default_rng(self.seed + 1)
        n, k = self.work["check"]["within"], len(self.pool)
        longest = max(m["L"] for m in self.metas)
        long_idx = [i for i in range(n) if self.metas[i % k]["L"] == longest]
        rest = [i for i in range(n) if i not in long_idx[:1]]
        pick = [int(rng.choice(long_idx))] + list(rng.choice(rest, self.work["check"]["requests"]
                                                               - 1, replace=False))
        self.sample = sorted(set(pick))
        self.served: dict = {}
        # warm each bucket's shapes twice, off the window's count
        seen: dict = {}
        for i, m in enumerate(self.metas * 2):
            if seen.get(m["L"], 0) < 2:
                self._request(self.pool[i % k])
                seen[m["L"]] = seen.get(m["L"], 0) + 1
        self.count = 0

    def _hook(self, module, inp, out):
        if self.capture:
            self.seen.append((inp[0], inp[1], out[0], out[1]))

    def _request(self, batch) -> list[list[int]]:
        from uasr_torch import infer

        infer.run_inference(self.cfg, self.model, self.fstate, [batch], vocab=self.vocab,
                            hyp_path=self.hyp, device=self.dev)
        with open(self.hyp) as f:
            lines = [line.rstrip("\n").split("\t") for line in f]
        os.remove(self.hyp)
        return [[self.ids[t] for t in line[1].split()] if len(line) > 1 and line[1] else []
                for line in lines]

    def run(self, seconds: float | None = None, calls: int | None = None) -> dict:
        lat, done, failed, tokens, utts = [], [], 0, 0, 0
        t0 = time.perf_counter()
        while True:
            i = self.count
            k = i % len(self.pool)
            self.capture = i in self.sample
            a = time.perf_counter()
            hyps = self._request(self.pool[k])
            lat.append(time.perf_counter() - a)
            failed += len(hyps) != self.metas[k]["B"]
            tokens, utts = tokens + sum(map(len, hyps)), utts + len(hyps)
            if self.capture:
                self.served[i] = (k, hyps, self.seen.pop())
                self.capture = False
            done.append(self.metas[k])
            self.count += 1
            if calls is not None and len(done) >= calls:
                break
            if calls is None and time.perf_counter() - t0 >= seconds:
                break
        wall = time.perf_counter() - t0
        audio = sum(m["audio_s"] for m in done)
        ms = [x * 1e3 for x in lat]
        return {"wall_s": wall, "calls": done, "attempted": len(done), "failed": failed,
                "e2e": {"serve_audio_s_per_s": audio / wall,
                        "request_p95_ms": percentile(ms, 95)},
                "notes": f"{len(done)} requests, {audio:.1f} audio-s in {wall:.3f} s, request "
                         f"p50 {percentile(ms, 50):.3f} ms p95 {percentile(ms, 95):.3f} ms, "
                         f"{tokens / max(utts, 1):.1f} tokens an utterance"}

    def release(self) -> None:
        self.model = self.fstate = None
        os.rmdir(self.tmp)
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
