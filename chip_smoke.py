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
   shapes the decode and training paths give them (TF32 off): K1 fused
   log-mel at B=32 x 16 s in each GEMM tier, K2 BiGRU forward at T=400,
   B=32, H=512 in f32 and bf16, K4 CTC prefix beam at T=400, B=32, W=16,
   V=32 without an LM and with bigram and trigram tables; K2-bwd BiGRU
   backward at T=400, B=32, H=512 in f32 and bf16, K3 CTC alpha and
   K3-bwd CTC beta at T=400, B=32, U=256 (S=513), V=32;
3. the decode path: ``run_inference`` at the full width of
   configs/librispeech_ctc_bigru.yaml on four requests of 32 seeded
   random utterances (4, 8, 12 and 16 s buckets), beam 16 and greedy,
   after one set-up request timed apart, with every kernel's launch
   count set to 0 before and read after each run; then the
   kernel path's logits against the plain path's, in bf16 and f32;
4. the training path: ``CTCTrainer.train_step`` at the same full width
   with the recipe's SpecAugment, clip and schedule, a set-up step and
   one step per bucket, each with its launch counts (1 K1, 3 K2, 3 K2-bwd,
   1 K3, 1 K3-bwd), a profile of one 16 s step, and the first step's loss
   and gradients on the kernel path against the plain path, bf16 and f32;
5. one JSON line listing every ported kernel with its check, times and
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
# the training step's CTC: 400 encoder frames, labels padded to
# max_label_len 256 (S = 513), V = 32
K3_T, K3_B, K3_U, K3_V = 400, 32, 256, 32

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
    full width, its SpecAugment and training sections included (they do not
    act on decode); the vocabulary file is absent, so V = vocab_size."""
    from uasr_torch.config import (
        Config, CTCConfig, DataConfig, FrontendConfig, ModelConfig, TrainConfig,
    )

    return Config(
        name="librispeech_ctc_bigru",
        frontend=FrontendConfig(feature_type="fbank", num_mel_bins=80, cmvn="utterance",
                                specaug_freq_mask=27, specaug_freq_masks=2,
                                specaug_time_mask=40, specaug_time_masks=2),
        model=ModelConfig(encoder="conv_bigru", hidden_size=512, num_gru_layers=3,
                          conv_channels=64, num_conv_layers=2, conv_time_stride=2,
                          conv_kernel=3, dtype="bfloat16", gru_pallas=True),
        ctc=CTCConfig(blank_id=0, use_pallas=True, use_beam=True, beam_width=16),
        data=DataConfig(batch_size=32, max_audio_seconds=16.0, max_label_len=256,
                        bucket_boundaries=(4.0, 8.0, 12.0, 16.0)),
        train=TrainConfig(mode="ctc", lr=6e-4, warmup_steps=2000, lr_schedule="warmup_rsqrt",
                          grad_clip=5.0),
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


def phase_train_kernels(torch, np, results: dict) -> None:
    """K2-bwd, K3 and K3-bwd against their plain versions at the shapes
    the training step gives them, with their times and bounds."""
    from uasr_torch.models import cuda_gru as k2
    from uasr_torch.ops import cuda_ctc as k3

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)

    # ---- K2-bwd at T=400, B=32, H=512, ragged lengths incl. 1 and T
    T, B, H = K2_T, K2_B, K2_H
    lengths = torch.randint(1, T + 1, (B,), device=dev, generator=gen)
    lengths[0], lengths[1] = T, 1
    tpos = torch.arange(T, device=dev)[:, None]
    tmask = torch.stack([tpos < lengths[None], tpos >= (T - lengths)[None]], 1)
    p0f = 0.5 * torch.randn(T, B, 3 * H, device=dev, generator=gen)
    p1f = 0.5 * torch.randn(T, B, 3 * H, device=dev, generator=gen)
    whf = torch.randn(2, H, 3 * H, device=dev, generator=gen) / H ** 0.5
    bhf = 0.1 * torch.randn(2, 3 * H, device=dev, generator=gen)
    doutf = torch.randn(T, B, 2 * H, device=dev, generator=gen) / B
    # relative to the largest reference value: f32 differs from the plain
    # version only in summation order; bf16 rounds dxp, dhn and dhproj at
    # every step, and a product next to a rounding boundary may round the
    # other way on one side: one bf16 ulp (2^-7) of the largest value
    for dtype, tol in (("float32", 1e-4), ("bfloat16", 2 ** -7)):
        dt = getattr(torch, dtype)
        args = tuple(x.to(dt).contiguous() for x in (p0f, p1f, whf, bhf)) + (tmask,)
        out = k2.bigru_scan_cuda(*args)
        dout = doutf.to(dt)
        got = k2.bigru_scan_bwd_cuda(*args, out, dout)
        ref = k2.bigru_scan_bwd_reference(*args, out, dout)
        torch.cuda.synchronize()
        scale = max(float(r.float().abs().max()) for r in ref)
        err = max(float((a.float() - r.float()).abs().max()) for a, r in zip(got, ref))
        print(f"K2-bwd     {dtype:8s} T={T} B={B} H={H} units/CTA={k2.LAST_UNITS_BWD}: "
              f"max|d| {err:.3e}, largest |ref| {scale:.3e}", flush=True)
        check(all(bool(torch.isfinite(a.float()).all()) for a in got),
              f"K2-bwd {dtype}: non-finite output")
        check(err <= tol * scale, f"K2-bwd {dtype}: max|d| {err:.3e} > {tol} x {scale:.3e}")
        ms = cuda_ms(torch, lambda: k2.bigru_scan_bwd_cuda(*args, out, dout), 5)
        plain = cuda_ms(torch, lambda: k2.bigru_scan_bwd_reference(*args, out, dout), 1)
        esize = 4 if dtype == "float32" else 2
        nbytes = (esize * (2 * T * B * 3 * H + 2 * H * 3 * H + 2 * 3 * H + 2 * T * B * 2 * H
                           + 2 * T * B * 3 * H + 2 * T * B * H) + 4 * T * 2 * B)
        bms, by = bound(nbytes, 2 * 2 * T * 2 * B * H * 3 * H, dtype)
        # cuDNN bidirectional GRU, forward + backward minus forward, on the
        # same unmasked shapes (input D = 2H): the one PyTorch call pair
        # that computes this function
        gru = torch.nn.GRU(2 * H, H, bidirectional=True).to(device=dev, dtype=dt)
        gru.flatten_parameters()
        x = torch.randn(T, B, 2 * H, device=dev, generator=gen).to(dt).requires_grad_()
        gy = torch.randn(T, B, 2 * H, device=dev, generator=gen).to(dt)
        fwd = cuda_ms(torch, lambda: gru(x)[0], 5)
        both = cuda_ms(torch, lambda: gru(x)[0].backward(gy), 5)
        lib = both - fwd
        print(f"  tol {tol} x largest |ref|; kernel {ms:.4f} ms plain {plain:.4f} ms cuDNN GRU "
              f"bwd {lib:.4f} ms (fwd+bwd {both:.4f} - fwd {fwd:.4f}) bound {bms:.4f} ms ({by})",
              flush=True)
        results[f"K2-bwd:{dtype}"] = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
                                          bound_by=by, library_ms=lib)

    # ---- K3 / K3-bwd at T=400, B=32, U=256, V=32: logit lengths over the
    # four buckets, ~14 characters per second (25 encoder frames per second)
    T, B, U, V = K3_T, K3_B, K3_U, K3_V
    rng = np.random.RandomState(SEED + 1)
    llen = rng.randint(T // 4, T + 1, B)
    llen[0], llen[1] = T, 0  # a full row and a zero-length padding row
    ulen = np.minimum(llen * 14 // 25, U)
    labels = rng.randint(1, V, (B, U))
    labels[np.arange(U)[None, :] >= ulen[:, None]] = 0
    logits = 3.0 * torch.randn(B, T, V, device=dev, generator=gen)
    llen_t, ulen_t = torch.tensor(llen, device=dev), torch.tensor(ulen, device=dev)
    labels_t = torch.tensor(labels, device=dev)
    emit, act, skip, svalid, finals = k3.ctc_inputs(logits, llen_t, labels_t, ulen_t)
    S = emit.shape[-1]
    traj = k3.ctc_alpha_cuda(emit, act, skip, svalid)
    traj_ref = k3.ctc_alpha_reference(emit, act, skip, svalid)
    ll = k3.final_ll(traj_ref[-1], finals)
    g = torch.full((B,), 1.0 / B, device=dev)
    demit = k3.ctc_beta_cuda(emit, act, skip, finals, traj_ref, ll, g)
    demit_ref = k3.ctc_beta_reference(emit, act, skip, finals, traj_ref, ll, g)
    torch.cuda.synchronize()
    # alpha: relative to |alpha| (values reach ~-1e3 on live states and the
    # log-zero -1e5 elsewhere; expf/logf round differently by an ulp)
    a_err = float((traj - traj_ref).abs().max())
    a_rel = float(((traj - traj_ref).abs() / (1.0 + traj_ref.abs())).max())
    ll_err = float((k3.final_ll(traj[-1], finals) - ll).abs().max())
    d_err = float((demit - demit_ref).abs().max())
    steps = int(llen.sum())
    print(f"K3 alpha   T={T} B={B} S={S} V={V}: max|d| {a_err:.3e}, max|d|/(1+|ref|) "
          f"{a_rel:.3e} (tol 1e-6), ll max|d| {ll_err:.3e} (tol 1e-3)", flush=True)
    print(f"K3-bwd     T={T} B={B} S={S} V={V}: demit max|d| {d_err:.3e} (tol 1e-5), "
          f"zero-length row zero: {not bool(demit[:, 1].any())}", flush=True)
    check(bool(torch.isfinite(traj).all()) and a_rel <= 1e-6 and ll_err <= 1e-3,
          f"K3: rel {a_rel:.3e} ll {ll_err:.3e}")
    check(bool(torch.isfinite(demit).all()) and d_err <= 1e-5 and not bool(demit[:, 1].any()),
          f"K3-bwd: max|d| {d_err:.3e}")
    ms_a = cuda_ms(torch, lambda: k3.ctc_alpha_cuda(emit, act, skip, svalid), 20)
    ms_b = cuda_ms(torch, lambda: k3.ctc_beta_cuda(emit, act, skip, finals, traj, ll, g), 20)
    plain_a = cuda_ms(torch, lambda: k3.ctc_alpha_reference(emit, act, skip, svalid), 2)
    plain_b = cuda_ms(torch, lambda: k3.ctc_beta_reference(emit, act, skip, finals, traj, ll, g),
                      2)
    # F.ctc_loss on the same log-probabilities: forward, and forward +
    # backward minus forward
    logp = torch.log_softmax(logits, -1).transpose(0, 1).detach().requires_grad_()
    lab = labels_t.long()

    def lib_fwd():
        return torch.nn.functional.ctc_loss(logp, lab, llen_t, ulen_t, reduction="sum")

    lib_a = cuda_ms(torch, lib_fwd, 20)
    lib_b = cuda_ms(torch, lambda: lib_fwd().backward(), 20) - lib_a
    # live work: the T loop runs every step, but only sum(llen) are active;
    # ~20 f32 operations per state and step (3 exp, 1 log, max, adds)
    tb = T * B * S * 4
    bms_a, by_a = bound(2 * tb + 4 * (T * B + 2 * B * S), 20 * steps * S, "float32")
    bms_b, by_b = bound(3 * tb + 4 * (T * B + 2 * B * S + 2 * B), 24 * steps * S, "float32")
    print(f"  K3 kernel {ms_a:.4f} ms plain {plain_a:.4f} ms F.ctc_loss fwd {lib_a:.4f} ms bound "
          f"{bms_a:.4f} ms ({by_a}); K3-bwd kernel {ms_b:.4f} ms plain {plain_b:.4f} ms "
          f"F.ctc_loss bwd {lib_b:.4f} ms bound {bms_b:.4f} ms ({by_b})", flush=True)
    results["K3"] = dict(max_abs_err=a_err, ms=ms_a, plain_ms=plain_a, bound_ms=bms_a,
                         bound_by=by_a, library_ms=lib_a)
    results["K3-bwd"] = dict(max_abs_err=d_err, ms=ms_b, plain_ms=plain_b, bound_ms=bms_b,
                             bound_by=by_b, library_ms=lib_b)


@contextlib.contextmanager
def plain_versions():
    """Route every kernel wrapper to its plain PyTorch version, so the
    same entry points run the plain path on CUDA tensors."""
    from uasr_torch.frontend import cuda_frontend as k1
    from uasr_torch.models import cuda_gru as k2
    from uasr_torch.ops import cuda_beam as k4
    from uasr_torch.ops import cuda_ctc as k3

    swaps = [(k1, "log_mel_fused_cuda", k1.log_mel_fused_reference),
             (k2, "bigru_scan_cuda", k2.bigru_scan_reference),
             (k2, "bigru_scan_bwd_cuda", k2.bigru_scan_bwd_reference),
             (k3, "ctc_alpha_cuda", k3.ctc_alpha_reference),
             (k3, "ctc_beta_cuda", k3.ctc_beta_reference),
             (k4, "ctc_beam_cuda", k4.ctc_beam_reference)]
    saved = [getattr(mod, name) for mod, name, _ in swaps]
    for mod, name, plain in swaps:
        setattr(mod, name, plain)
    try:
        yield
    finally:
        for (mod, name, _), fn in zip(swaps, saved):
            setattr(mod, name, fn)


def _counters():
    from uasr_torch.frontend import cuda_frontend
    from uasr_torch.models import cuda_gru
    from uasr_torch.ops import cuda_beam, cuda_ctc

    return {"K1": (cuda_frontend, "LAUNCHES"), "K2": (cuda_gru, "LAUNCHES"),
            "K2-bwd": (cuda_gru, "LAUNCHES_BWD"), "K3": (cuda_ctc, "LAUNCHES"),
            "K3-bwd": (cuda_ctc, "LAUNCHES_BWD"), "K4": (cuda_beam, "LAUNCHES")}


def reset_launches():
    for mod, name in _counters().values():
        setattr(mod, name, 0)


def read_launches() -> dict:
    return {key: getattr(mod, name) for key, (mod, name) in _counters().items()}


def profile_call(torch, fn, what: str) -> None:
    """Device time by kernel and the device's busy share over one call of
    ``fn`` (torch.profiler; the profiler's own cost inflates the wall
    time). The call ends in a synchronise."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    if not by_name:
        print("  profile: the profiler recorded no device time (not measured)", flush=True)
        return
    busy = sum(by_name.values())
    print(f"  profile, {what}: call wall {wall_us / 1e3:.2f} ms, device busy "
          f"{busy / 1e3:.2f} ms ({busy / wall_us:.1%}; idle {1 - busy / wall_us:.1%})",
          flush=True)
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:14]:
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
            check(counts["K2-bwd"] == counts["K3"] == counts["K3-bwd"] == 0,
                  f"decode launched a training kernel {counts}")
            launches.update({k: counts[k] for k in ("K1", "K2", "K4")})
            profile_call(torch, lambda: infer.run_inference(run_cfg, model, fstate,
                                                            requests[-1:], vocab=vocab,
                                                            device=dev),
                         f"one {requests[-1].audio.shape[1] / 16000:.1f} s request")

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


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def phase_train(torch, np, launches: dict) -> None:
    """The training step through CTCTrainer at the recipe's full width:
    a set-up step, then one step per bucket with its launch counts, a
    profile of one 16 s step, and the first step's loss and gradients on
    the kernel path against the plain path from the same weights and
    batch."""
    from uasr_torch import train

    dev = torch.device(DEVICE)
    vocab = char_vocab()
    cfg = recipe_config(len(vocab))
    trainer = train.CTCTrainer(cfg, device=dev)
    state = trainer.init_state()
    init_params = {k: v.detach().clone() for k, v in state.params.items()}
    batches = make_requests(np, cfg)
    sr = cfg.frontend.sample_rate
    print(f"train: {cfg.name} H={cfg.model.hidden_size} x{cfg.model.num_gru_layers} BiGRU, "
          f"{cfg.model.dtype}, V={cfg.dim_output}, B={cfg.data.batch_size}, SpecAugment "
          f"{cfg.frontend.specaug_freq_masks}x{cfg.frontend.specaug_freq_mask} + "
          f"{cfg.frontend.specaug_time_masks}x{cfg.frontend.specaug_time_mask}, "
          f"{cfg.train.lr_schedule} lr {cfg.train.lr}, clip {cfg.train.grad_clip}", flush=True)

    def step(b):
        nonlocal state
        state, aux = trainer.train_step(state, b)
        return float(aux["loss"]), float(aux["grad_norm"])

    # the first step of the process also pays cuDNN / cuBLAS set-up
    t0 = time.perf_counter()
    loss, gnorm = step(batches[-1])
    torch.cuda.synchronize()
    print(f"  set-up step (16 s bucket): wall {(time.perf_counter() - t0) * 1e3:.2f} ms, "
          f"loss {loss:.4f}, grad_norm {gnorm:.4f}", flush=True)
    want = {"K1": 1, "K2": 3, "K2-bwd": 3, "K3": 1, "K3-bwd": 1, "K4": 0}
    total = dict.fromkeys(want, 0)
    for b in batches:
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, gnorm = step(b)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_launches()
        secs = float(np.sum(b.audio_lengths)) / sr
        print(f"  step {state.step} {b.audio.shape[1] / sr:5.1f} s bucket: wall {wall * 1e3:.2f} "
              f"ms, {secs / wall:.1f} audio-s/s, loss {loss:.4f}, grad_norm {gnorm:.4f}, "
              f"launches {counts}", flush=True)
        check(np.isfinite(loss) and loss > 0 and np.isfinite(gnorm), f"step {state.step}: "
              f"loss {loss} grad_norm {gnorm}")
        check(counts == want, f"step {state.step}: launches {counts}, expected {want}")
        for k, v in counts.items():
            total[k] += v
    check(all(bool(torch.isfinite(p).all()) for p in state.params.values()),
          "non-finite parameters after training")
    launches.update({k: total[k] for k in ("K2-bwd", "K3", "K3-bwd")})
    profile_call(torch, lambda: step(batches[-1]), "one 16 s training step")

    # kernel path vs plain path: loss and gradients of the first step (the
    # initial weights; after it, SpecAugment's zeroed bands make the conv
    # front's LayerNorm amplify any difference ~1/sqrt(eps)), same batch and
    # SpecAugment draw, every kernel swapped for its plain version. bf16:
    # the BiGRU carry and K2-bwd's products round to bf16 at every step,
    # and a value next to a rounding boundary may round the other way; f32:
    # summation order only; both: the order of the gather's scatter-add
    db = trainer.to_device(batches[-1])
    params = init_params
    for dtype, (tl, tn, tw) in (("bfloat16", (1e-3, 1e-2, 5e-2)), ("float32", (1e-5, 1e-4, 1e-3))):
        t = train.CTCTrainer(dataclasses.replace(cfg, model=dataclasses.replace(cfg.model,
                                                                                dtype=dtype)),
                             device=dev)
        aux_k, g_k = t.loss_and_grads(params, db, t.step_generator(0))
        with plain_versions():
            aux_p, g_p = t.loss_and_grads(params, db, t.step_generator(0))
        lk, lp = float(aux_k["loss"]), float(aux_p["loss"])
        nk = float(train.global_norm(g_k.values()))
        npl = float(train.global_norm(g_p.values()))
        worst = max((float(torch.linalg.vector_norm(g_k[k] - g_p[k])
                           / torch.linalg.vector_norm(g_p[k]).clamp_min(1e-30)), k)
                    for k in g_p)
        print(f"  step, kernel path vs plain path, {dtype}: loss {lk:.6f} vs {lp:.6f} (rel "
              f"{_rel(lk, lp):.3e}, tol {tl}), grad norm {nk:.6f} vs {npl:.6f} (rel "
              f"{_rel(nk, npl):.3e}, tol {tn}), worst tensor |dg|/|g| {worst[0]:.3e} "
              f"({worst[1]}, tol {tw})", flush=True)
        check(np.isfinite(lk) and _rel(lk, lp) <= tl, f"{dtype}: loss {lk} vs plain {lp}")
        check(np.isfinite(nk) and _rel(nk, npl) <= tn, f"{dtype}: grad norm {nk} vs plain {npl}")
        check(worst[0] <= tw, f"{dtype}: gradient of {worst[1]} off by {worst[0]:.3e}")


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
    phase_train_kernels(torch, np, results)
    launches: dict = {}
    phase_slice(torch, np, launches)
    phase_train(torch, np, launches)

    rows = [
        ("K1 fused log-mel", "uasr_torch/csrc/log_mel.cu",
         "uasr/frontend/pallas_frontend.py:125", "K1", "K1:highest"),
        ("K2 BiGRU forward", "uasr_torch/csrc/bigru_fwd.cu",
         "uasr/models/pallas_gru.py:537", "K2", "K2:bfloat16"),
        ("K4 CTC prefix beam", "uasr_torch/csrc/ctc_beam.cu",
         "uasr/ops/pallas_beam.py:70", "K4", "K4:none"),
        ("K2-bwd BiGRU backward", "uasr_torch/csrc/bigru_bwd.cu",
         "uasr/models/pallas_gru.py:567", "K2-bwd", "K2-bwd:bfloat16"),
        ("K3 CTC alpha", "uasr_torch/csrc/ctc_alpha.cu",
         "uasr/ops/pallas_ctc.py:64", "K3", "K3"),
        ("K3-bwd CTC beta / d(emit)", "uasr_torch/csrc/ctc_beta.cu",
         "uasr/ops/pallas_ctc.py:89", "K3-bwd", "K3-bwd"),
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
