#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``uasr_torch``).

Run from the repository root on a machine with one NVIDIA H100 and the
CUDA toolkit:

    python3 chip_smoke.py

Phases, each of which raises on failure (so the script exits non-zero
and prints no result line):

1. card: name and power limit, and the build of the kernels from
   ``uasr_torch/csrc`` (one nvcc per source, all at once);
2. kernels against their plain PyTorch versions on the card, at the
   shapes the decode path gives them (TF32 off): K1 fused log-mel at
   B=32 x 16 s in each GEMM tier, K2 BiGRU forward at T=400, B=32,
   H=512 in f32 and bf16, K4 CTC prefix beam at T=400, B=32, W=16, V=32
   without an LM and with bigram and trigram tables;
3. the slice: ``run_inference`` at the full width of
   configs/librispeech_ctc_bigru.yaml on four requests of 32 seeded
   random utterances (4, 8, 12 and 16 s buckets), beam 16 and greedy,
   after one set-up request timed apart, with every kernel's launch
   count set to 0 before and read after each run; then the
   kernel path's logits against the plain path's, in bf16 and f32;
4. one JSON line listing every ported kernel with its check, times and
   bound, then the card line and the result line.

It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 0
DEVICE = "cuda"
# the shapes the decode path gives each kernel: B=32 requests up to 16 s;
# 16 s -> 1598 frames -> 400 encoder frames after two stride-2 convs
K1_B, K1_SECONDS = 32, 16
K2_T, K2_B, K2_H = 400, 32, 512
K4_T, K4_B, K4_W, K4_V = 400, 32, 16, 32

# NVIDIA H100 SXM data sheet, dense: HBM bytes/s, FLOP/s by operand type
PEAK_BYTES = 3.35e12
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def bound(nbytes: float, ops: float, dtype: str) -> tuple[float, str]:
    """Least time (ms) for the work, and what sets it."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cuda_ms(torch, fn, reps: int, warmup: int = 1) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def recipe_config(vocab_size: int):
    """configs/librispeech_ctc_bigru.yaml (BASELINE.json config #3) at
    full width; SpecAugment and the training sections do not act on
    decode, and the vocabulary file is absent, so V = vocab_size."""
    from uasr_torch.config import Config, CTCConfig, DataConfig, FrontendConfig, ModelConfig

    return Config(
        name="librispeech_ctc_bigru",
        frontend=FrontendConfig(feature_type="fbank", num_mel_bins=80, cmvn="utterance"),
        model=ModelConfig(encoder="conv_bigru", hidden_size=512, num_gru_layers=3,
                          conv_channels=64, num_conv_layers=2, conv_time_stride=2,
                          conv_kernel=3, dtype="bfloat16", gru_pallas=True),
        ctc=CTCConfig(blank_id=0, use_pallas=True, use_beam=True, beam_width=16),
        data=DataConfig(batch_size=32, max_audio_seconds=16.0, max_label_len=256,
                        bucket_boundaries=(4.0, 8.0, 12.0, 16.0)),
        vocab_size=vocab_size,
    )


def char_vocab():
    """Stand-in character set: blank, 26 letters, apostrophe, space and
    three specials (V = 32)."""
    from uasr_torch.vocab import BLK, PAD, UNK, Vocab

    letters = [chr(ord("a") + i) for i in range(26)]
    return Vocab(tokens=[BLK, *letters, "'", "<space>", UNK, PAD, "<eos>"], blank_id=0)


def make_requests(np, cfg, n_req: int = 4):
    """One batch per bucket boundary; lengths spread over the bucket, the
    longest exactly at the boundary, ~14 characters per second."""
    from uasr_torch.data.dataset import Batch

    rng = np.random.RandomState(SEED)
    sr, B, V = cfg.frontend.sample_rate, cfg.data.batch_size, cfg.dim_output
    out = []
    for hi_s in cfg.data.bucket_boundaries[:n_req]:
        lo_s = max(hi_s - 4.0, 1.0)
        secs = rng.uniform(lo_s, hi_s, B)
        secs[0] = hi_s
        lens = (secs * sr).astype(np.int32)
        L = int(lens.max())
        audio = (0.1 * rng.randn(B, L)).astype(np.float32)
        audio[np.arange(L)[None, :] >= lens[:, None]] = 0.0
        ulen = np.minimum((secs * 14).astype(np.int32), cfg.data.max_label_len)
        labels = rng.randint(1, V - 3, (B, cfg.data.max_label_len)).astype(np.int32)
        labels[np.arange(labels.shape[1])[None, :] >= ulen[:, None]] = 0
        out.append(Batch(audio, lens, labels, ulen))
    return out


def phase_kernels(torch, np, results: dict) -> None:
    from uasr_torch.frontend import cuda_frontend as k1
    from uasr_torch.frontend.features import make_frontend_state, num_frames_static
    from uasr_torch.models import cuda_gru as k2
    from uasr_torch.ops import cuda_beam as k4
    from uasr_torch.config import FrontendConfig

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    # ---- K1 at B=32 x 16 s
    fcfg = FrontendConfig(num_mel_bins=80)
    fstate = make_frontend_state(fcfg, device=dev)
    B, L = K1_B, K1_SECONDS * fcfg.sample_rate
    audio = 0.1 * torch.randn(B, L, device=dev, generator=gen)
    FL, FS, NFFT = fcfg.frame_length, fcfg.frame_shift, fcfg.n_fft
    T = num_frames_static(L, FL, FS)
    NB, M = NFFT // 2 + 1, fcfg.num_mel_bins
    nbytes = 4 * (B * L + 2 * FL * NB + 2 * NB + NB * M + B * T * M)
    flop = 2 * B * T * FL * 2 * NB + 2 * B * T * NB * M
    for tier, tol, products, dtype in (("highest", 1e-4, 1, "float32"),
                                       ("high", 5e-4, 3, "bfloat16"),
                                       ("bfloat16", 2e-2, 1, "bfloat16")):
        args = (audio, fstate, FL, FS, NFFT)
        got = k1.log_mel_fused_cuda(*args, precision=tier)
        ref = k1.log_mel_fused_reference(*args, precision=tier)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        check(bool(torch.isfinite(got).all()), f"K1 {tier}: non-finite output")
        check(err <= tol, f"K1 {tier}: max|d| {err:.3e} > {tol}")
        ms = cuda_ms(torch, lambda: k1.log_mel_fused_cuda(*args, precision=tier), 20)
        plain = cuda_ms(torch, lambda: k1.log_mel_fused_reference(*args, precision=tier), 5)
        bms, by = bound(nbytes, products * flop, dtype)
        print(f"K1 log_mel {tier:8s} B={B} L={L} T={T}: max|d| {err:.3e} (tol {tol}) "
              f"kernel {ms:.4f} ms plain {plain:.4f} ms bound {bms:.4f} ms ({by})", flush=True)
        results[f"K1:{tier}"] = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
                                     bound_by=by, library_ms=None)

    # ---- K2 at T=400, B=32, H=512, ragged lengths incl. 1 and T
    T, B, H = K2_T, K2_B, K2_H
    lengths = torch.randint(1, T + 1, (B,), device=dev, generator=gen)
    lengths[0], lengths[1] = T, 1
    tpos = torch.arange(T, device=dev)[:, None]
    tmask = torch.stack([tpos < lengths[None], tpos >= (T - lengths)[None]], 1)
    p0f = 0.5 * torch.randn(T, B, 3 * H, device=dev, generator=gen)
    p1f = 0.5 * torch.randn(T, B, 3 * H, device=dev, generator=gen)
    whf = torch.randn(2, H, 3 * H, device=dev, generator=gen) / H ** 0.5
    bhf = 0.1 * torch.randn(2, 3 * H, device=dev, generator=gen)
    for dtype, tol in (("float32", 1e-4), ("bfloat16", 2e-2)):
        dt = getattr(torch, dtype)
        args = tuple(x.to(dt).contiguous() for x in (p0f, p1f, whf, bhf)) + (tmask,)
        got = k2.bigru_scan_cuda(*args)
        ref = k2.bigru_scan_reference(*args)
        torch.cuda.synchronize()
        err = float((got.float() - ref.float()).abs().max())
        check(bool(torch.isfinite(got.float()).all()), f"K2 {dtype}: non-finite output")
        check(err <= tol, f"K2 {dtype}: max|d| {err:.3e} > {tol}")
        ms = cuda_ms(torch, lambda: k2.bigru_scan_cuda(*args), 10)
        plain = cuda_ms(torch, lambda: k2.bigru_scan_reference(*args), 2)
        esize = 4 if dtype == "float32" else 2
        nbytes = esize * (2 * T * B * 3 * H + 2 * H * 3 * H + 2 * 3 * H + T * B * 2 * H) + 4 * T * 2 * B
        bms, by = bound(nbytes, 2 * T * 2 * B * H * 3 * H, dtype)
        # cuDNN GRU on the same unmasked shapes (its input projection from
        # D = 2H included): the one PyTorch call computing this function
        gru = torch.nn.GRU(2 * H, H, bidirectional=True).to(device=dev, dtype=dt)
        # one f32 weight buffer; PyTorch does not flatten bf16 RNN weights, so
        # the bf16 time includes cuDNN's re-pack of them on every call
        gru.flatten_parameters()
        x =torch.randn(T, B, 2 * H, device=dev, generator=gen).to(dt)
        with torch.inference_mode():
            lib = cuda_ms(torch, lambda: gru(x), 10)
        print(f"K2 bigru   {dtype:8s} T={T} B={B} H={H} units/CTA={k2.LAST_UNITS}: "
              f"max|d| {err:.3e} (tol {tol}) kernel {ms:.4f} ms plain {plain:.4f} ms "
              f"cuDNN GRU {lib:.4f} ms bound {bms:.4f} ms ({by})", flush=True)
        results[f"K2:{dtype}"] = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
                                      bound_by=by, library_ms=lib)

    # ---- K4 at T=400, B=32, W=16, V=32
    T, B, W, V = K4_T, K4_B, K4_W, K4_V
    logits = 4.0 * torch.randn(B, T, V, device=dev, generator=gen)
    logp = torch.log_softmax(logits, -1).contiguous()
    lengths = torch.randint(1, T + 1, (B,), device=dev, generator=gen)
    lengths[0], lengths[1] = T, 1
    rng = np.random.RandomState(SEED)
    tables = {
        "none": (None, 0),
        "bigram": (np.log(rng.dirichlet(np.ones(V), V + 1)), 2),
        "trigram": (np.log(rng.dirichlet(np.ones(V), (V + 1) ** 2)), 3),
    }
    for name, (tab, order) in tables.items():
        lm = None if tab is None else torch.tensor(tab, dtype=torch.float32, device=dev)
        args = (logp, lengths, W, 0, lm, order, 0.5, 0.3)
        got = k4.beam_traceback(*k4.ctc_beam_cuda(*args))
        ref = k4.beam_traceback(*k4.ctc_beam_reference(*args))
        torch.cuda.synchronize()
        check(bool(torch.equal(got[0], ref[0])), f"K4 {name}: ids differ")
        check(bool(torch.equal(got[1], ref[1])), f"K4 {name}: lengths differ")
        err = float((got[2] - ref[2]).abs().max())
        check(err <= 1e-4, f"K4 {name}: score max|d| {err:.3e} > 1e-4")
        ms = cuda_ms(torch, lambda: k4.ctc_beam_cuda(*args), 10)
        plain = cuda_ms(torch, lambda: k4.ctc_beam_reference(*args), 1, warmup=0)
        # work of the steps this run's lengths keep active
        steps = int(torch.clamp(lengths, max=T).sum())
        K = W * V + W
        ops = steps * (W * V * (2 + 4 * (order > 0)) + 8 * W + 6 * W * W + 2 * W * K + 20 * W)
        nbytes = 4 * (B * T * V + B + (0 if tab is None else tab.size) + 2 * T * B * W + 2 * B * W)
        bms, by = bound(nbytes, ops, "float32")
        print(f"K4 beam    {name:8s} T={T} B={B} W={W} V={V}: ids equal, score max|d| "
              f"{err:.3e} kernel {ms:.4f} ms plain {plain:.4f} ms bound {bms:.6f} ms ({by})",
              flush=True)
        results[f"K4:{name}"] = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
                                     bound_by=by, library_ms=None)


@contextlib.contextmanager
def plain_versions():
    """Route every kernel wrapper to its plain PyTorch version, so the
    same entry points run the plain path on CUDA tensors."""
    from uasr_torch.frontend import cuda_frontend as k1
    from uasr_torch.models import cuda_gru as k2
    from uasr_torch.ops import cuda_beam as k4

    saved = (k1.log_mel_fused_cuda, k2.bigru_scan_cuda, k4.ctc_beam_cuda)
    k1.log_mel_fused_cuda = k1.log_mel_fused_reference
    k2.bigru_scan_cuda = k2.bigru_scan_reference
    k4.ctc_beam_cuda = k4.ctc_beam_reference
    try:
        yield
    finally:
        k1.log_mel_fused_cuda, k2.bigru_scan_cuda, k4.ctc_beam_cuda = saved


def reset_launches():
    from uasr_torch.frontend import cuda_frontend
    from uasr_torch.models import cuda_gru
    from uasr_torch.ops import cuda_beam

    cuda_frontend.LAUNCHES = cuda_gru.LAUNCHES = cuda_beam.LAUNCHES = 0


def read_launches() -> dict:
    from uasr_torch.frontend import cuda_frontend
    from uasr_torch.models import cuda_gru
    from uasr_torch.ops import cuda_beam

    return {"K1": cuda_frontend.LAUNCHES, "K2": cuda_gru.LAUNCHES, "K4": cuda_beam.LAUNCHES}


def profile_request(torch, infer, cfg, model, fstate, request, vocab, dev) -> None:
    """Device time by kernel and the device's busy share over one request
    (torch.profiler; the profiler's own cost inflates the wall time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        # the whole call, the audio's upload included, ends in a synchronise
        infer.run_inference(cfg, model, fstate, [request], vocab=vocab, device=dev)
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    if not by_name:
        print("  profile: the profiler recorded no device time (not measured)", flush=True)
        return
    busy = sum(by_name.values())
    print(f"  profile, one {request.audio.shape[1] / 16000:.1f} s request: call wall "
          f"{wall_us / 1e3:.2f} ms, device busy {busy / 1e3:.2f} ms "
          f"({busy / wall_us:.1%}; idle {1 - busy / wall_us:.1%})", flush=True)
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        print(f"    {us / 1e3:9.3f} ms {us / busy:6.1%}  {name[:90]}", flush=True)


def phase_slice(torch, np, launches: dict) -> None:
    from uasr_torch import infer
    from uasr_torch.frontend.features import (
        compute_features, make_frontend_state, num_frames_static,
    )
    from uasr_torch.models.layers import conv_out_length
    from uasr_torch.models.models import build_model

    dev = torch.device(DEVICE)
    vocab = char_vocab()
    cfg = recipe_config(len(vocab))
    model = build_model(cfg.model, cfg.dim_output, cfg.frontend.dim_input,
                        generator=torch.Generator().manual_seed(SEED), device=dev)
    fstate = make_frontend_state(cfg.frontend, device=dev)
    requests = make_requests(np, cfg)
    print(f"slice: {cfg.name} H={cfg.model.hidden_size} x{cfg.model.num_gru_layers} BiGRU, "
          f"{cfg.model.dtype}, V={cfg.dim_output}, {len(requests)} requests of B="
          f"{cfg.data.batch_size}", flush=True)

    # the first request of the process also pays cuDNN and cuBLAS set-up
    # and lazy module loading; it is timed apart from the measured runs
    warm = infer.run_inference(cfg, model, fstate, requests[:1], vocab=vocab, device=dev)
    print(f"  first request (set-up included): wall "
          f"{warm['rtf'] * warm['audio_seconds'] * 1e3:.2f} ms", flush=True)

    for mode, use_beam in (("beam16", True), ("greedy", False)):
        run_cfg = dataclasses.replace(cfg, ctc=dataclasses.replace(cfg.ctc, use_beam=use_beam))
        reset_launches()
        res = [infer.run_inference(run_cfg, model, fstate, [b], vocab=vocab, device=dev)
               for b in requests]
        counts = read_launches()
        for b, r in zip(requests, res):
            wall = r["rtf"] * r["audio_seconds"]
            check(np.isfinite(r["per"]) and r["ref_tokens"] > 0, f"{mode}: bad score {r}")
            print(f"  {mode} request {b.audio.shape[1] / 16000:5.1f} s bucket: wall "
                  f"{wall * 1e3:.2f} ms, {r['audio_seconds'] / wall:.1f} audio-s/s, "
                  f"RTF {r['rtf']:.3e}, PER {r['per']:.3f}", flush=True)
        print(f"  {mode} launches: {counts}", flush=True)
        check(counts["K1"] > 0 and counts["K2"] > 0, f"{mode}: K1/K2 not launched {counts}")
        if use_beam:
            check(infer.LAST_BEAM_IMPL == "cuda", f"beam ran {infer.LAST_BEAM_IMPL}")
            check(counts["K4"] > 0, f"beam: K4 not launched {counts}")
            launches.update(counts)
            profile_request(torch, infer, run_cfg, model, fstate, requests[-1], vocab, dev)

    # kernel path vs plain path: the same entry points with every kernel
    # swapped for its plain version, same weights, 16 s request
    b = requests[-1]
    audio = torch.as_tensor(b.audio, device=dev)
    alen = torch.as_tensor(b.audio_lengths, device=dev, dtype=torch.long)
    t_enc = conv_out_length(
        num_frames_static(b.audio.shape[1], cfg.frontend.frame_length, cfg.frontend.frame_shift),
        cfg.model.conv_time_stride, cfg.model.num_conv_layers)
    for dtype, tol in (("bfloat16", 5e-2), ("float32", 1e-3)):
        m = build_model(dataclasses.replace(cfg.model, dtype=dtype), cfg.dim_output,
                        cfg.frontend.dim_input, device=dev)
        m.load_state_dict(model.state_dict())

        def logits():
            with torch.inference_mode():
                return m(*compute_features(audio, alen, fstate, cfg.frontend))

        lk, nk = logits()
        with plain_versions():
            lp, npl = logits()
        check(lk.shape == (b.audio.shape[0], t_enc, cfg.dim_output),
              f"logits shape {tuple(lk.shape)}")
        check(bool(torch.isfinite(lk).all()), f"{dtype}: non-finite logits")
        check(bool(torch.equal(nk, npl)), f"{dtype}: output lengths differ")
        err = float((lk - lp).abs().max())
        check(err <= tol, f"{dtype}: kernel-path logits max|d| {err:.3e} > {tol}")
        print(f"  logits kernel path vs plain path, {dtype}: max|d| {err:.3e} (tol {tol})",
              flush=True)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    if not os.path.isfile(os.path.join(REPO, "uasr_torch", "_build.py")):
        raise SystemExit("chip_smoke: the uasr_torch package is not beside this script")
    sys.path.insert(0, REPO)
    from uasr_torch import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}; torch {torch.__version__} CUDA {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    _build.build()
    print(f"built {', '.join(_build.SOURCES)} in {time.perf_counter() - t0:.1f} s", flush=True)

    results: dict = {}
    phase_kernels(torch, np, results)
    launches: dict = {}
    phase_slice(torch, np, launches)

    rows = [
        ("K1 fused log-mel", "uasr_torch/csrc/log_mel.cu",
         "uasr/frontend/pallas_frontend.py:125", "K1", "K1:highest"),
        ("K2 BiGRU forward", "uasr_torch/csrc/bigru_fwd.cu",
         "uasr/models/pallas_gru.py:537", "K2", "K2:bfloat16"),
        ("K4 CTC prefix beam", "uasr_torch/csrc/ctc_beam.cu",
         "uasr/ops/pallas_beam.py:70", "K4", "K4:none"),
    ]
    kernels = [dict(name=name, route="cuda", source=src, replaces=rep,
                    launches=launches[key], **results[res])
               for name, src, rep, key, res in rows]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
