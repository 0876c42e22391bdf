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
   H=512 in f32 and bf16 at B=32 (timed, with its plan) and at B=7 and 1,
   K4 CTC prefix beam at T=400, B=32, W=16, V=32 without an LM and with
   bigram and trigram tables (timed, with its plan and us a step); K2-bwd BiGRU
   backward at T=400, B=32, H=512 in f32 and bf16 (its coefficient kernel
   also alone, and timed apart from its reverse chain), K3 CTC alpha and
   K3-bwd CTC beta at T=400, B=32, U=256 (S=513), V=32; K7 unfused
   log-mel on one streaming chunk of 64 streams (240 + 64 x 160 samples)
   in each tier, K4 at V=4233, W=8 over one chunk's 32 logits frames from
   a carried state and over a 12 s utterance's 600 (backpointers and
   state bit-equal; plan and us a step);
3. the decode path: ``run_inference`` at the full width of
   configs/librispeech_ctc_bigru.yaml on four requests of 32 seeded
   random utterances (4, 8, 12 and 16 s buckets), beam 16 and greedy,
   after one set-up request timed apart, with every kernel's launch
   count set to 0 before and read after each run; two more beam-16
   requests of 1 and 7 of the 16 s utterances (a bucket's last partial
   batch), each with 3 K2 launches and a finite PER; then the
   kernel path's logits against the plain path's, in bf16 and f32;
4. the training path: ``CTCTrainer.train_step`` at the same full width
   with the recipe's SpecAugment, clip and schedule, a set-up step and
   one step per bucket, each with its launch counts (1 K1, 3 K2, 3 K2-bwd
   chains and 3 of their coefficient kernels, 1 K3, 1 K3-bwd), a profile of one 16 s step, and the first step's loss
   and gradients on the kernel path against the plain path, bf16 and f32;
5. the streaming path of configs/aishell_streaming.yaml at full width
   (random cnn weights, the blank bias raised so ~4 characters per second
   are emitted, V = 4233 stand-in): 64 streams of 1 to 12 s through
   ``StreamingRecognizer`` init / step / finish, greedy partials against
   the offline greedy decode and beam-8 finals against ``run_inference``
   with beam 8, exactly 1 K7, 1 K4 and 0 K1 per step, per-chunk latency at
   B=64 and B=8, a profile of one step;
6. the TCP daemon on localhost with 8 slots: 8 staggered clients with a
   ninth refused as busy, then 8 clients streaming 3 utterances each back
   to back (the sustained audio-s/s), every final equal to the offline
   beam decode;
7. K5 grouped GRU at the recurrent encoders' shapes (H=384, f32: 12 s
   offline T=300 B=64, the lc_bigru backward windows T=24 B=1216, one
   streaming step's windows T=24 B=64; ragged lengths, and offline and at
   the windows every row live too, with K5's plan) and K6 fused attention at the
   attention encoders' (B=32, T=400, 8 heads of 64, bf16, with the
   conformer's bias and without, f32; and T=832, a 33 s utterance, bf16
   with the bias), against their plain versions;
8. the recurrent streaming path: configs/aishell_streaming.yaml with
   ``model.encoder=lc_bigru`` and then ``uni_gru`` (``gru_pallas``), 64
   streams through StreamingRecognizer, greedy and beam 8, against the
   offline decode (and the beam finals against the offline beam of the
   streamed logits), with num_gru_layers K5 per lc_bigru step (none per
   uni_gru step) and latency at B=64 and B=8; then a short lc_bigru daemon
   round (8 slots);
9. the attention decode path: configs/librispeech_ctc_bigru.yaml with
   ``model.encoder=conformer`` and ``transformer`` (``attn_pallas``; the
   conformer's relative-position tables drawn N(0, 0.3^2)) through
   ``run_inference``, the conformer also on one request of 4 utterances
   up to 33 s (T = 825, padded to 832), transformer_layers K6 per
   request, logits against the plain path;
10. K5's coefficient outputs, K5-bwd (and its coefficient kernel alone)
   and K8 at the recurrent encoders' training shapes (H=384: the 12 s
   forward GRU T=300 B=64, the lc_bigru backward windows T=24 B=1216) in
   f32 and bf16 with ragged lengths, and in f32 with every row live, as
   cuDNN's yardstick runs, and K6-bwd at the
   attention encoders' (B=32, T=400, 8 heads of 64: bf16 with the
   conformer's bias and without, f32; T=832 bf16 with the bias), against
   their plain versions, d_bias bit-equal over two launches;
11. the training paths of those four encoders: ``CTCTrainer.train_step``
   at full width (aishell_streaming with lc_bigru and uni_gru, B=64, 4 to
   12 s, ``ctc.use_pallas``; librispeech with conformer and transformer,
   B=32, 4 to 16 s, the recipe's SpecAugment, clip and schedule), a set-up
   step and one step per bucket with exact launch counts, one lc_bigru step
   with the linear backward (K8), a profile of one 12 s lc_bigru step and
   of one 16 s conformer and transformer step, and the first step's loss
   and gradients on the kernel path against the plain path, bf16 and f32;
12. the unsupervised path: configs/formant39_unsup.yaml at full width
   (gan+eodm alternations through GANTrainer: the first one's losses on
   the kernel path against the plain path, timed alternations with one
   K1 per step, a profile), WGAN-GP at configs/timit_unsup_gan_eodm.yaml's
   widths with the CTC mix-in through run_gan_training (K1, K3, K3-bwd),
   configs/synthetic_unsup_demo.yaml's 600 steps through the CLI
   (reproducible: trained twice, bit-equal) to dev PER below 0.65 with
   greedy and K4 beam decode, and that checkpoint streamed with the
   merged-stream collapse (K7), equal to the offline merged greedy decode;
   phase 2 also prints K1's and K7's distance from the same formula in f64;
13. one JSON line listing every ported kernel with its check, times and
   bound, then the card line and the result line.

It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
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
# the streaming path (configs/aishell_streaming.yaml): 64 streams of up to
# 12 s in chunks of 64 frames; K7 takes the glued chunk of 240 + 64 * 160
# pre-emphasised samples, K4 one chunk's 32 logits frames (600 for a 12 s
# utterance offline) over the stand-in vocabulary of 4233 symbols, beam 8
STREAM_B, STREAM_SECONDS, STREAM_V, STREAM_W = 64, 12, 4233, 8
DAEMON_SLOTS = 8

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


def make_request(np, rng, cfg, B: int, hi_s: float, cps: float = 14):
    """B utterances of random audio spread over (hi_s - 4, hi_s] seconds, the
    longest exactly hi_s, ``cps`` characters per second (labels capped at
    max_label_len)."""
    from uasr_torch.data.dataset import Batch

    sr, V = cfg.frontend.sample_rate, cfg.dim_output
    lo_s = max(hi_s - 4.0, 1.0)
    secs = rng.uniform(lo_s, hi_s, B)
    secs[0] = hi_s
    lens = (secs * sr).astype(np.int32)
    L = int(lens.max())
    audio = (0.1 * rng.randn(B, L)).astype(np.float32)
    audio[np.arange(L)[None, :] >= lens[:, None]] = 0.0
    ulen = np.minimum((secs * cps).astype(np.int32), cfg.data.max_label_len)
    labels = rng.randint(1, V - 3, (B, cfg.data.max_label_len)).astype(np.int32)
    labels[np.arange(labels.shape[1])[None, :] >= ulen[:, None]] = 0
    return Batch(audio, lens, labels, ulen)


def make_requests(np, cfg, n_req: int = 4, cps: float = 14):
    """One batch of data.batch_size per bucket boundary (make_request)."""
    rng = np.random.RandomState(SEED)
    return [make_request(np, rng, cfg, cfg.data.batch_size, hi_s, cps)
            for hi_s in cfg.data.bucket_boundaries[:n_req]]


def against_f64(torch, kernel, plain, audio, fstate, *args) -> str:
    """The kernel's and the f32 plain version's max |d| against the same
    log-mel formula in f64 (the plain version on the f32 inputs and
    constants promoted to f64, ``highest`` tier), which has no summation
    order to share, where the f32 plain version sums in cuBLAS's order for
    the row count; and where the kernel's largest |d| sits (mel bin and
    the f64 value there), and the share of its elements past 1e-4."""
    from uasr_torch.frontend.features import FrontendState

    st64 = FrontendState(*(x.double() if x is not None and x.is_floating_point() else x
                           for x in fstate))
    ref = plain(audio.double(), st64, *args, precision="highest")
    d_k = (kernel(audio, fstate, *args, precision="highest").double() - ref).abs()
    d_p = (plain(audio, fstate, *args, precision="highest").double() - ref).abs()
    at = int(d_k.argmax())
    return (f"kernel max|d| {float(d_k.max()):.3e} (mel bin {at % ref.shape[-1]}, f64 value "
            f"{float(ref.reshape(-1)[at]):.3f}; {float((d_k > 1e-4).double().mean()):.2e} of "
            f"the elements past 1e-4), f32 plain version max|d| {float(d_p.max()):.3e}")


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
    # the mel product counted over the filterbank's nonzero entries
    nnz = int((fstate.mel_fb != 0).sum())
    flop = 2 * B * T * FL * 2 * NB + 2 * B * T * nnz
    for tier, tol, products, dtype in (("highest", 1e-4, 1, "float32"),
                                       ("high", 5e-4, 3, "bfloat16"),
                                       ("bfloat16", 2e-2, 1, "bfloat16")):
        args = (audio, fstate, FL, FS, NFFT)
        got = k1.log_mel_fused_cuda(*args, precision=tier)
        print(f"K1 plan {tier}: {json.dumps(k1.LAST_PLAN)}", flush=True)
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
    print(f"K1 log_mel highest B={B} L={L} against f64: "
          + against_f64(torch, k1.log_mel_fused_cuda, k1.log_mel_fused_reference, audio, fstate,
                        FL, FS, NFFT), flush=True)

    # ---- K2 at T=400, H=512, ragged lengths incl. 1 and T: B=32, timed, then
    # B=7 and B=1 (a bucket's last partial batch; refused before K2 ran K5's plan)
    T, H = K2_T, K2_H
    for B in (K2_B, 7, 1):
        lengths = torch.randint(1, T + 1, (B,), device=dev, generator=gen)
        lengths[0] = T
        if B > 1:
            lengths[1] = 1
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
            plan = f"plan {k2.LAST_BIGRU_PLAN} (units/CTA, splits) wh {k2.LAST_BIGRU_WH}"
            ref = k2.bigru_scan_reference(*args)
            torch.cuda.synchronize()
            err = float((got.float() - ref.float()).abs().max())
            check(bool(torch.isfinite(got.float()).all()), f"K2 {dtype} B={B}: non-finite output")
            check(err <= tol, f"K2 {dtype} B={B}: max|d| {err:.3e} > {tol}")
            if B != K2_B:
                print(f"K2 bigru   {dtype:8s} T={T} B={B} H={H} {plan}: max|d| {err:.3e} "
                      f"(tol {tol})", flush=True)
                continue
            ms = cuda_ms(torch, lambda: k2.bigru_scan_cuda(*args), 10)
            plain = cuda_ms(torch, lambda: k2.bigru_scan_reference(*args), 2)
            # the work of the row-steps the masks keep live, both directions: a
            # masked row-step only carries h forward, so it needs neither its
            # xp row nor the product; out is written at every row-step
            steps = int(tmask.sum())
            esize = 4 if dtype == "float32" else 2
            nbytes = (esize * (steps * 3 * H + 2 * H * 3 * H + 2 * 3 * H + T * B * 2 * H)
                      + 4 * T * 2 * B)
            bms, by = bound(nbytes, 2 * steps * H * 3 * H, dtype)
            # cuDNN GRU on the same unmasked shapes (its input projection from
            # D = 2H included): the one PyTorch call computing this function
            gru = torch.nn.GRU(2 * H, H, bidirectional=True).to(device=dev, dtype=dt)
            # one f32 weight buffer; PyTorch does not flatten bf16 RNN weights, so
            # the bf16 time includes cuDNN's re-pack of them on every call
            gru.flatten_parameters()
            x = torch.randn(T, B, 2 * H, device=dev, generator=gen).to(dt)
            with torch.inference_mode():
                lib = cuda_ms(torch, lambda: gru(x), 10)
            print(f"K2 bigru   {dtype:8s} T={T} B={B} H={H} {plan}: max|d| {err:.3e} (tol "
                  f"{tol}) kernel {ms:.4f} ms plain {plain:.4f} ms cuDNN GRU {lib:.4f} ms bound "
                  f"{bms:.4f} ms ({by}); live row-steps {steps} of {2 * T * B}", flush=True)
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
        res = check_beam(torch, k4, args, f"K4 {name}")
        ms = cuda_ms(torch, lambda: k4.ctc_beam_cuda(*args), 10)
        plain = cuda_ms(torch, lambda: k4.ctc_beam_reference(*args), 1, warmup=0)
        bms, by = beam_bound(lengths, T, B, W, V, 0 if tab is None else tab.size, order)
        print(f"K4 beam    {name:8s} T={T} B={B} W={W} V={V}: backpointers, state and ids "
              f"equal, score max|d| {res['max_abs_err']:.3e} kernel {ms:.4f} ms "
              f"({beam_plan(k4, ms, lengths)}) plain {plain:.4f} ms bound {bms:.6f} ms ({by})",
              flush=True)
        results[f"K4:{name}"] = dict(res, ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
                                     library_ms=None)


def check_beam(torch, k4, args, what: str, state=None) -> dict:
    """K4 against its plain version on the same inputs (and start state):
    backpointers and the state out bit-equal, tracebacks equal, best
    scores to 1e-4."""
    got = k4.ctc_beam_cuda(*args, state=state)
    ref = k4.ctc_beam_reference(*args, state=state)
    torch.cuda.synchronize()
    check(bool(torch.equal(got[0], ref[0])), f"{what}: parents differ")
    check(bool(torch.equal(got[1], ref[1])), f"{what}: chars differ")
    for field, a, b in zip(ref[2]._fields, got[2], ref[2]):
        check(bool(torch.equal(a, b)), f"{what}: state {field} differs")
    blank = args[3]
    ids, n, score = k4.beam_traceback(got[0], got[1], got[2].p_b, got[2].p_nb, blank)
    r_ids, r_n, r_score = k4.beam_traceback(ref[0], ref[1], ref[2].p_b, ref[2].p_nb, blank)
    check(bool(torch.equal(ids, r_ids)) and bool(torch.equal(n, r_n)), f"{what}: ids differ")
    err = float((score - r_score).abs().max())
    check(err <= 1e-4, f"{what}: score max|d| {err:.3e} > 1e-4")
    return dict(max_abs_err=err)


def beam_plan(k4, ms: float, lengths) -> str:
    """K4's launch plan and its µs per step of the longest utterance."""
    warps, ctas = k4.LAST_BEAM_PLAN
    return (f"{warps} warps x {ctas} CTA(s) per utterance, "
            f"{ms * 1e3 / max(int(lengths.max()), 1):.3f} us/step")


def beam_bound(lengths, T: int, B: int, W: int, V: int, lm_size: int, order: int):
    """K4's least time: the work of the steps this run's lengths keep
    active (the W*V extends with their LM terms, the fold, one top-W
    selection pass of ~2 comparisons per candidate over the W*V + W
    candidates, the rebuild), and the bytes of log-probs, lengths, LM
    table, backpointers and state."""
    steps = int(lengths.clamp(max=T).sum())
    K = W * V + W
    ops = steps * (W * V * (2 + 4 * (order > 0)) + 8 * W + 6 * W * W + 2 * K + 20 * W)
    nbytes = 4 * (B * T * V + B + lm_size + 2 * T * B * W + 2 * 6 * B * W)
    return bound(nbytes, ops, "float32")


def phase_train_kernels(torch, np, results: dict) -> None:
    """K2-bwd (and its coefficient kernel alone), K3 and K3-bwd against
    their plain versions at the shapes the training step gives them, with
    their times and bounds."""
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
    steps = int(tmask.sum())  # row-steps the masks keep active, both directions
    for dtype, tol in (("float32", 1e-4), ("bfloat16", 2 ** -7)):
        dt = getattr(torch, dtype)
        args = tuple(x.to(dt).contiguous() for x in (p0f, p1f, whf, bhf)) + (tmask,)
        out = k2.bigru_scan_cuda(*args)
        dout = doutf.to(dt)
        got = k2.bigru_scan_bwd_cuda(*args, out, dout)
        plan = (k2.LAST_BIGRU_BWD_WH, *k2.LAST_BIGRU_BWD_PLAN)
        ref = k2.bigru_scan_bwd_reference(*args, out, dout)
        c4, ch = k2.bigru_bwd_coeffs_cuda(*args, out)
        r_c4, r_ch = k2.bigru_bwd_coeffs_reference(*args, out)
        torch.cuda.synchronize()
        scale = max(float(r.float().abs().max()) for r in ref)
        err = max(float((a.float() - r.float()).abs().max()) for a, r in zip(got, ref))
        # the coefficient kernel alone reads the same out as its plain
        # version: f32 1e-5, bf16 one bf16 ulp of the largest
        c_err = max(float((a - r).abs().max()) for a, r in ((c4, r_c4), (ch, r_ch)))
        c_tol = 1e-5 if dtype == "float32" else 2 ** -7 * float(r_c4.abs().max())
        print(f"K2-bwd     {dtype:8s} T={T} B={B} H={H} (wh, units/CTA, splits) {plan}: "
              f"max|d| {err:.3e}, largest |ref| {scale:.3e}; coefficient kernel max|d| "
              f"{c_err:.3e} (tol {c_tol:.3e})", flush=True)
        check(all(bool(torch.isfinite(a.float()).all()) for a in (*got, c4, ch)),
              f"K2-bwd {dtype}: non-finite output")
        check(err <= tol * scale, f"K2-bwd {dtype}: max|d| {err:.3e} > {tol} x {scale:.3e}")
        check(c_err <= c_tol, f"K2-bwd coefficient kernel {dtype}: max|d| {c_err:.3e}")
        ms = cuda_ms(torch, lambda: k2.bigru_scan_bwd_cuda(*args, out, dout), 5)
        ms_c = cuda_ms(torch, lambda: k2.bigru_bwd_coeffs_cuda(*args, out), 5)
        ms_ch = cuda_ms(torch, lambda: k2.bigru_bwd_chain_cuda(c4, ch, args[2], dout), 5)
        plain = cuda_ms(torch, lambda: k2.bigru_scan_bwd_reference(*args, out, dout), 1)
        esize = 4 if dtype == "float32" else 2
        nbytes = (esize * (2 * T * B * 3 * H + 2 * H * 3 * H + 2 * 3 * H + 2 * T * B * 2 * H
                           + 2 * T * B * 3 * H + 2 * T * B * H) + 4 * T * 2 * B)
        # the gate product over every row-step (the masks do not skip it)
        # and the chain's product over the live ones
        bms, by = bound(nbytes, 2 * (T * 2 * B + steps) * H * 3 * H, dtype)
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
        print(f"  tol {tol} x largest |ref|; kernel {ms:.4f} ms (coefficient kernel alone "
              f"{ms_c:.4f}, reverse chain alone {ms_ch:.4f}) plain {plain:.4f} ms cuDNN GRU "
              f"bwd {lib:.4f} ms (fwd+bwd {both:.4f} - fwd {fwd:.4f}) bound {bms:.4f} ms ({by}); "
              f"live row-steps {steps} of {2 * T * B}", flush=True)
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
    longest = int(llen.max())
    print(f"  K3 kernel {ms_a:.4f} ms ({ms_a * 1e3 / longest:.3f} us a step; threads, ring depth "
          f"{k3.LAST_ALPHA_PLAN}) plain {plain_a:.4f} ms F.ctc_loss fwd {lib_a:.4f} ms bound "
          f"{bms_a:.4f} ms ({by_a}); K3-bwd kernel {ms_b:.4f} ms ({ms_b * 1e3 / longest:.3f} us "
          f"a step; {k3.LAST_BETA_PLAN}) plain {plain_b:.4f} ms F.ctc_loss bwd {lib_b:.4f} ms "
          f"bound {bms_b:.4f} ms ({by_b})", flush=True)
    results["K3"] = dict(max_abs_err=a_err, ms=ms_a, plain_ms=plain_a, bound_ms=bms_a,
                         bound_by=by_a, library_ms=lib_a)
    results["K3-bwd"] = dict(max_abs_err=d_err, ms=ms_b, plain_ms=plain_b, bound_ms=bms_b,
                             bound_by=by_b, library_ms=lib_b)


def phase_stream_kernels(torch, np, results: dict) -> None:
    """K7 and K4 at the shapes the streaming path gives them: K7 on one
    chunk of 64 streams in each GEMM tier; K4 at V = 4233, W = 8 over one
    chunk's 32 logits frames from a carried state, and over a 12 s
    utterance's 600 from a fresh one."""
    from uasr_torch.config import FrontendConfig
    from uasr_torch.frontend import cuda_frontend as k7
    from uasr_torch.frontend.features import make_frontend_state
    from uasr_torch.ops import cuda_beam as k4

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)

    # ---- K7 at B=64 x one chunk (64 frames)
    fcfg = FrontendConfig(num_mel_bins=80, cmvn="streaming", streaming_chunk_frames=64)
    fstate = make_frontend_state(fcfg, device=dev)
    FL, FS, NFFT = fcfg.frame_length, fcfg.frame_shift, fcfg.n_fft
    B, T = STREAM_B, fcfg.streaming_chunk_frames
    L = (FL - FS) + T * FS
    audio = 0.1 * torch.randn(B, L, device=dev, generator=gen)
    NB, M = NFFT // 2 + 1, fcfg.num_mel_bins
    nbytes = 4 * (B * L + FL + 2 * FL * NB + NB * M + B * T * M)
    nnz = int((fstate.mel_fb != 0).sum())  # the mel product's nonzero entries
    flop = B * T * FL + 2 * B * T * FL * 2 * NB + 2 * B * T * nnz
    for tier, tol, products, dtype in (("highest", 1e-4, 1, "float32"),
                                       ("high", 5e-4, 3, "bfloat16"),
                                       ("bfloat16", 2e-2, 1, "bfloat16")):
        args = (audio, fstate, FL, FS, NFFT)
        got = k7.log_mel_unfused_cuda(*args, precision=tier)
        print(f"K7 plan {tier}: {json.dumps(k7.LAST_PLAN)}", flush=True)
        ref = k7.log_mel_unfused_reference(*args, precision=tier)
        torch.cuda.synchronize()
        check(got.shape == (B, T, M), f"K7 {tier}: shape {tuple(got.shape)}")
        check(bool(torch.isfinite(got).all()), f"K7 {tier}: non-finite output")
        err = float((got - ref).abs().max())
        check(err <= tol, f"K7 {tier}: max|d| {err:.3e} > {tol}")
        ms = cuda_ms(torch, lambda: k7.log_mel_unfused_cuda(*args, precision=tier), 50)
        plain = cuda_ms(torch, lambda: k7.log_mel_unfused_reference(*args, precision=tier), 20)
        bms, by = bound(nbytes, products * flop, dtype)
        print(f"K7 log_mel {tier:8s} B={B} L={L} T={T}: max|d| {err:.3e} (tol {tol}) "
              f"kernel {ms:.4f} ms plain {plain:.4f} ms bound {bms:.4f} ms ({by})", flush=True)
        results[f"K7:{tier}"] = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
                                     bound_by=by, library_ms=None)
    # against f64, at this chunk and at 32-frame chunks (64 x 32 = 2048 rows,
    # where cuBLAS splits the f32 plain version's sums)
    for frames in (T, 32):
        a = audio[:, : (FL - FS) + frames * FS].contiguous()
        print(f"K7 log_mel highest B={B} x {frames} frames against f64: "
              + against_f64(torch, k7.log_mel_unfused_cuda, k7.log_mel_unfused_reference, a,
                            fstate, FL, FS, NFFT), flush=True)

    # ---- K4 at V=4233, W=8: one chunk from a carried state, then 12 s
    V, W = STREAM_V, STREAM_W
    chunk_t, full_t = T // 2, STREAM_SECONDS * 50
    for what, T4, carried in (("chunk", chunk_t, True), ("offline", full_t, False)):
        logp = torch.log_softmax(4.0 * torch.randn(B, T4, V, device=dev, generator=gen),
                                 -1).contiguous()
        lengths = torch.randint(0, T4 + 1, (B,), device=dev, generator=gen)
        lengths[0], lengths[1] = T4, (0 if carried else 1)
        state = None
        if carried:  # the state a previous chunk of 32 frames left
            first = torch.log_softmax(4.0 * torch.randn(B, T4, V, device=dev, generator=gen),
                                      -1).contiguous()
            state = k4.ctc_beam_reference(first, torch.full((B,), T4, device=dev), W)[2]
        args = (logp, lengths, W, 0)
        res = check_beam(torch, k4, args, f"K4 V={V} {what}", state=state)
        ms = cuda_ms(torch, lambda: k4.ctc_beam_cuda(*args, state=state), 20 if carried else 5)
        plain = cuda_ms(torch, lambda: k4.ctc_beam_reference(*args, state=state), 1, warmup=0)
        bms, by = beam_bound(lengths, T4, B, W, V, 0, 0)
        print(f"K4 beam    {what:8s} T={T4} B={B} W={W} V={V} "
              f"{'carried' if carried else 'fresh'} state: backpointers, state and ids equal, "
              f"score max|d| {res['max_abs_err']:.3e} kernel {ms:.4f} ms "
              f"({beam_plan(k4, ms, lengths)}) plain {plain:.4f} ms bound {bms:.4f} ms ({by})",
              flush=True)
        results[f"K4:V{V}:{what}"] = dict(res, ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
                                          library_ms=None)


@contextlib.contextmanager
def plain_versions():
    """Route every kernel wrapper to its plain PyTorch version, so the
    same entry points run the plain path on CUDA tensors."""
    from uasr_torch.frontend import cuda_frontend as k1
    from uasr_torch.models import cuda_gru as k2
    from uasr_torch.ops import cuda_attention as k6
    from uasr_torch.ops import cuda_beam as k4
    from uasr_torch.ops import cuda_ctc as k3

    swaps = [(k2, "gru_scan_cuda", k2.gru_scan_reference),
             (k2, "gru_scan_bwd_cuda", k2.gru_scan_bwd_reference),
             (k2, "gru_scan_bwd_lin_cuda", k2.gru_scan_bwd_lin_reference),
             (k6, "mhsa_fwd_cuda", k6.mhsa_fwd_reference),
             (k6, "mhsa_bwd_cuda", k6.mhsa_bwd_reference),
             (k1, "log_mel_fused_cuda", k1.log_mel_fused_reference),
             (k1, "log_mel_unfused_cuda", k1.log_mel_unfused_reference),
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
    from uasr_torch.ops import cuda_attention, cuda_beam, cuda_ctc

    return {"K1": (cuda_frontend, "LAUNCHES"), "K7": (cuda_frontend, "LAUNCHES_UNFUSED"),
            "K2": (cuda_gru, "LAUNCHES"),
            "K2-bwd": (cuda_gru, "LAUNCHES_BWD"),
            "K2-bwd:coeffs": (cuda_gru, "LAUNCHES_BWD_COEFFS"), "K3": (cuda_ctc, "LAUNCHES"),
            "K3-bwd": (cuda_ctc, "LAUNCHES_BWD"), "K4": (cuda_beam, "LAUNCHES"),
            "K5": (cuda_gru, "LAUNCHES_GRU"), "K6": (cuda_attention, "LAUNCHES_ATTN"),
            "K5-bwd": (cuda_gru, "LAUNCHES_GRU_BWD"),
            "K5-bwd:coeffs": (cuda_gru, "LAUNCHES_GRU_COEFFS"), "K8": (cuda_gru, "LAUNCHES_GRU_LIN"),
            "K6-bwd": (cuda_attention, "LAUNCHES_ATTN_BWD")}


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
    from uasr_torch.data.dataset import Batch
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
            check(counts["K2-bwd"] == counts["K2-bwd:coeffs"] == counts["K3"] == counts["K3-bwd"]
                  == counts["K7"] == 0, f"decode launched a training kernel {counts}")
            launches.update({k: counts[k] for k in ("K1", "K2", "K4")})
            profile_call(torch, lambda: infer.run_inference(run_cfg, model, fstate,
                                                            requests[-1:], vocab=vocab,
                                                            device=dev),
                         f"one {requests[-1].audio.shape[1] / 16000:.1f} s request")

    # a bucket's last partial batch: 1 and 7 utterances of the 16 s request,
    # beam 16 (K2 refused both at H = 512 before it ran K5's plan)
    beam_cfg = dataclasses.replace(cfg, ctc=dataclasses.replace(cfg.ctc, use_beam=True))
    for n in (1, 7):
        part = Batch(*(x[:n] for x in requests[-1]))
        reset_launches()
        r = infer.run_inference(beam_cfg, model, fstate, [part], vocab=vocab, device=dev)
        counts = read_launches()
        wall = r["rtf"] * r["audio_seconds"]
        print(f"  beam16 request of {n} utterance(s), {part.audio.shape[1] / 16000:.1f} s "
              f"bucket: wall {wall * 1e3:.2f} ms, PER {r['per']:.3f}, launches K1 "
              f"{counts['K1']} K2 {counts['K2']} K4 {counts['K4']}", flush=True)
        check(np.isfinite(r["per"]) and r["ref_tokens"] > 0, f"{n} utterances: bad score {r}")
        check(counts["K2"] == cfg.model.num_gru_layers and counts["K4"] > 0,
              f"{n} utterances: launches {counts}")

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
    want = {"K1": 1, "K7": 0, "K2": 3, "K2-bwd": 3, "K2-bwd:coeffs": 3, "K3": 1, "K3-bwd": 1,
            "K4": 0, "K5": 0, "K6": 0, "K5-bwd": 0, "K5-bwd:coeffs": 0, "K8": 0, "K6-bwd": 0}
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
    # SpecAugment draw (both dtypes also differ in the order of the gather's
    # scatter-add)
    compare_first_step(torch, cfg, init_params, trainer.to_device(batches[-1]), "step")


def compare_first_step(torch, cfg, params, db, what: str, floor: float = 0.0) -> None:
    """Loss and gradients of one step of ``cfg``'s trainer at ``params`` on
    the kernel path against the plain path (every kernel swapped for its
    plain version), same batch and SpecAugment draw, in bf16 and f32. Bars:
    bf16 loss 1e-3, grad norm 1e-2, worst tensor 5e-2 (carries and products
    round to bf16 at every step, and a value next to a rounding boundary may
    round the other way); f32 1e-5, 1e-4 and 1e-3 (summation order only). A
    tensor's error is relative to its gradient's norm, or to ``floor`` times
    the global norm where that is larger: a gradient at the rounding floor
    (the attention key projections' bias, which the softmax ignores) is
    rounding noise on both paths."""
    from uasr_torch import train

    dev = torch.device(DEVICE)
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
                           / torch.linalg.vector_norm(g_p[k]).clamp_min(max(floor * npl, 1e-30))),
                     k) for k in g_p)
        print(f"  {what}, kernel path vs plain path, {dtype}: loss {lk:.6f} vs {lp:.6f} (rel "
              f"{_rel(lk, lp):.3e}, tol {tl}), grad norm {nk:.6f} vs {npl:.6f} (rel "
              f"{_rel(nk, npl):.3e}, tol {tn}), worst tensor |dg|/|g| {worst[0]:.3e} "
              f"({worst[1]}, tol {tw})", flush=True)
        check(math.isfinite(lk) and _rel(lk, lp) <= tl, f"{what} {dtype}: loss {lk} vs plain {lp}")
        check(math.isfinite(nk) and _rel(nk, npl) <= tn,
              f"{what} {dtype}: grad norm {nk} vs plain {npl}")
        check(worst[0] <= tw, f"{what} {dtype}: gradient of {worst[1]} off by {worst[0]:.3e}")


def aishell_config(encoder: str = "cnn"):
    """configs/aishell_streaming.yaml (BASELINE.json config #4) as the
    recipe gives it, or with ``model.encoder`` set to a causal recurrent
    encoder and ``model.gru_pallas`` on (the other model settings are the
    recipe's and ModelConfig's defaults: 2 GRU layers, lc_chunk 16,
    lc_lookahead 8); its vocabulary file is absent, so V is the 4233 of the
    public AISHELL-1 character recipes."""
    from uasr_torch.config import load_config

    cfg = load_config(os.path.join(REPO, "configs", "aishell_streaming.yaml")).replace(
        vocab_size=STREAM_V)
    if encoder != "cnn":
        cfg = cfg.replace(model=dataclasses.replace(cfg.model, encoder=encoder, gru_pallas=True))
    return cfg


def aishell_vocab():
    """Stand-in character set of the AISHELL-1 recipes' size: blank,
    <unk>, 4230 characters and <sos/eos> (V = 4233)."""
    from uasr_torch.vocab import BLK, UNK, Vocab

    return Vocab(tokens=[BLK, UNK, *(f"c{i:04d}" for i in range(STREAM_V - 3)), "<sos/eos>"],
                 blank_id=0)


def make_streams(np, cfg, B: int, seed: int):
    """B seeded random utterances of 1 to 12 s (the first exactly 12 s),
    zero-padded to whole chunks, with ~4 characters per second of labels:
    a Batch whose audio the streams are cut from."""
    from uasr_torch.data.dataset import Batch

    rng = np.random.RandomState(seed)
    sr = cfg.frontend.sample_rate
    cs = cfg.frontend.streaming_chunk_frames * cfg.frontend.frame_shift
    secs = rng.uniform(1.0, STREAM_SECONDS, B)
    secs[0] = STREAM_SECONDS
    lens = (secs * sr).astype(np.int32)
    L = -(-int(lens.max()) // cs) * cs
    audio = (0.1 * rng.randn(B, L)).astype(np.float32)
    audio[np.arange(L)[None, :] >= lens[:, None]] = 0.0
    ulen = np.minimum((secs * 4).astype(np.int32), cfg.data.max_label_len)
    labels = rng.randint(2, cfg.dim_output - 1, (B, cfg.data.max_label_len)).astype(np.int32)
    labels[np.arange(labels.shape[1])[None, :] >= ulen[:, None]] = 0
    return Batch(audio, lens, labels, ulen)


def offline_ids(cfg, model, fstate, batch, vocab, dev, use_beam: bool) -> list:
    """The offline decode (``run_inference``, ``--mode infer``) of a batch:
    each utterance's token ids, read back from its hypothesis file."""
    import tempfile

    from uasr_torch import infer

    run_cfg = dataclasses.replace(cfg, ctc=dataclasses.replace(cfg.ctc, use_beam=use_beam))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "hyp.txt")
        infer.run_inference(run_cfg, model, fstate, [batch], vocab=vocab, hyp_path=path,
                            device=dev)
        with open(path) as f:
            lines = [line.rstrip("\n").split("\t") for line in f]
    check(len(lines) == len(batch.audio_lengths), f"{len(lines)} hypotheses")
    if use_beam:
        check(infer.LAST_BEAM_IMPL == "cuda", f"offline beam ran {infer.LAST_BEAM_IMPL}")
    return [vocab.encode(toks.split()) if toks else [] for _, toks in lines]


def stream_batch(torch, np, rec, batch, per_step=None):
    """Feed a batch's streams chunk by chunk (host audio, as a server
    receives it) through init / step / finish. Returns the concatenated
    step outputs, finish's outputs and each step's latency (s, host clock,
    ended by reading the step's ids back). ``per_step(launch delta)`` sees
    each step's kernel launches."""
    B = len(batch.audio_lengths)
    cs = rec.chunk_samples
    st = rec.init(B, batch.audio_lengths)
    partial = [[] for _ in range(B)]
    lat = []
    for off in range(0, batch.audio.shape[1], cs):
        before = read_launches()
        t0 = time.perf_counter()
        st, ids, n = rec.step(st, batch.audio[:, off:off + cs])
        ids, n = ids.cpu().numpy(), n.cpu().numpy()
        lat.append(time.perf_counter() - t0)
        if per_step is not None:
            after = read_launches()
            per_step({k: after[k] - before[k] for k in after})
        for b in range(B):
            partial[b] += ids[b, : n[b]].tolist()
    st, ids, n = rec.finish(st)
    ids, n = ids.cpu().numpy(), n.cpu().numpy()
    return partial, [ids[b, : n[b]].tolist() for b in range(B)], lat, st


def phase_stream(torch, np, launches: dict) -> None:
    """The streaming path of configs/aishell_streaming.yaml at full width:
    64 streams of 1 to 12 s through StreamingRecognizer, greedy and beam 8,
    against the offline decode of the same chunk-padded audio; launch
    counts per step; latency at B = 64 and B = 8; a profile of one step."""
    from uasr_torch.frontend.features import make_frontend_state
    from uasr_torch.models.models import build_model
    from uasr_torch.serve import StreamingRecognizer

    dev = torch.device(DEVICE)
    cfg = aishell_config()
    vocab = aishell_vocab()
    check(len(vocab) == cfg.dim_output, f"vocabulary of {len(vocab)}")
    model = build_model(cfg.model, cfg.dim_output, cfg.frontend.dim_input,
                        generator=torch.Generator().manual_seed(SEED), device=dev)
    fstate = make_frontend_state(cfg.frontend, device=dev)
    batch = make_streams(np, cfg, STREAM_B, SEED + 3)
    calibrate_blank(torch, cfg, model, fstate, batch, dev)
    rec = StreamingRecognizer(cfg, model, device=dev)
    chunk_s = rec.chunk_samples / cfg.frontend.sample_rate
    print(f"stream: {cfg.name} cnn H={cfg.model.hidden_size}, {cfg.model.dtype}, V="
          f"{cfg.dim_output}, beam {cfg.ctc.beam_width}, {STREAM_B} streams of "
          f"{batch.audio_lengths.min() / 16000:.2f}-{batch.audio_lengths.max() / 16000:.2f} s, "
          f"chunk {rec.chunk} frames ({chunk_s} s), window {rec.window} frames", flush=True)

    # offline references: --mode infer on the same chunk-padded audio (the
    # first call also pays cuDNN / cuBLAS set-up)
    ref_greedy = offline_ids(cfg, model, fstate, batch, vocab, dev, use_beam=False)
    ref_beam = offline_ids(cfg, model, fstate, batch, vocab, dev, use_beam=True)
    cap = cfg.data.max_label_len
    over = sum(len(r) > cap for r in ref_beam)
    print(f"  offline: greedy {np.mean([len(r) for r in ref_greedy]):.1f} tokens per "
          f"utterance, beam {np.mean([len(r) for r in ref_beam]):.1f}; {over} beam transcripts "
          f"over the {cap}-token prefix cap", flush=True)

    # greedy: the partials, concatenated with finish's tail, are the offline
    # greedy decode
    greedy = StreamingRecognizer(
        dataclasses.replace(cfg, ctc=dataclasses.replace(cfg.ctc, use_beam=False)), model,
        device=dev)
    want_greedy = {"K1": 0, "K7": 1, "K2": 0, "K2-bwd": 0, "K2-bwd:coeffs": 0, "K3": 0,
                   "K3-bwd": 0, "K4": 0, "K5": 0, "K6": 0, "K5-bwd": 0, "K5-bwd:coeffs": 0,
                   "K8": 0, "K6-bwd": 0}

    def greedy_step(d):
        check(d == want_greedy, f"greedy step launches {d}, expected {want_greedy}")

    part, tail, _, _ = stream_batch(torch, np, greedy, batch, greedy_step)
    got = [p + t for p, t in zip(part, tail)]
    bad = [b for b in range(STREAM_B) if got[b] != ref_greedy[b]]
    print(f"  greedy: streamed == offline for {STREAM_B - len(bad)} of {STREAM_B} streams",
          flush=True)
    check(not bad, f"greedy streams {bad[:8]} differ from the offline decode")

    # beam 8, the recipe's mode: the main path of this slice, counted
    want = dict(want_greedy, K4=1)
    steps = 0

    def beam_step(d):
        nonlocal steps
        steps += 1
        check(d == want, f"beam step launches {d}, expected {want}")

    reset_launches()
    part, final, lat, _ = stream_batch(torch, np, rec, batch, beam_step)
    counts = read_launches()
    print(f"  beam: {steps} steps + finish, launches {counts}", flush=True)
    check(counts["K7"] == steps and counts["K4"] == steps + 1 and counts["K1"] == 0,
          f"beam path launches {counts}")
    launches.update({"K7": counts["K7"], "K4:stream": counts["K4"]})
    check(sum(len(p) for p in part) > 0, "beam mode emitted no greedy partials")
    bad = [b for b in range(STREAM_B) if final[b] != ref_beam[b][:cap]]
    print(f"  beam: finish == offline beam {cfg.ctc.beam_width} for {STREAM_B - len(bad)} of "
          f"{STREAM_B} streams", flush=True)
    check(not bad, f"beam streams {bad[:8]} differ from the offline beam decode")
    report_latency(np, f"B={STREAM_B}", lat[1:], STREAM_B, chunk_s)

    # 8 streams: the daemon's slot count
    small = make_streams(np, cfg, DAEMON_SLOTS, SEED + 4)
    _, _, lat8, _ = stream_batch(torch, np, rec, small)
    report_latency(np, f"B={DAEMON_SLOTS}", lat8[1:], DAEMON_SLOTS, chunk_s)

    # one mid-stream step of 64 streams under the profiler
    st = rec.init(STREAM_B, batch.audio_lengths)
    cs = rec.chunk_samples
    mid = batch.audio.shape[1] // cs // 2
    for k in range(mid):
        st, _, _ = rec.step(st, batch.audio[:, k * cs:(k + 1) * cs])

    def one_step():
        rec.step(st, batch.audio[:, mid * cs:(mid + 1) * cs])[1].cpu()

    profile_call(torch, one_step, f"one streaming step of {STREAM_B} streams")


def calibrate_blank(torch, cfg, model, fstate, batch, dev) -> None:
    """Random weights emit a character at nearly every frame; a trained
    CTC model emits blank at most. Raise the blank logit's bias to about
    the 96th percentile of (best character - blank) over this batch's
    frames, so few frames emit a character and a 12 s utterance's beam
    transcript stays under the 64-token prefix cap (data.max_label_len).
    The shift sits in the middle of the widest gap between neighbouring
    frame margins within the 95th to 97th percentiles: a shift equal to one
    frame's margin would tie blank and that frame's best character
    exactly, and the streamed and offline paths (whose logits differ in
    the last bits) could break the tie differently."""
    from uasr_torch.frontend.features import compute_features

    audio = torch.as_tensor(batch.audio, device=dev)
    alen = torch.as_tensor(batch.audio_lengths, device=dev, dtype=torch.long)
    with torch.inference_mode():
        logits, n = model(*compute_features(audio, alen, fstate, cfg.frontend))
        valid = torch.arange(logits.shape[1], device=dev)[None, :] < n[:, None]
        blank = cfg.ctc.blank_id
        margin = logits.clone()
        margin[..., blank] = -float("inf")
        margin = (margin.max(-1).values - logits[..., blank])[valid].float().sort().values
        lo, hi = int(0.95 * len(margin)), int(0.97 * len(margin))
        gaps = margin[lo + 1:hi + 1] - margin[lo:hi]
        k = lo + int(gaps.argmax())
        shift = float((margin[k] + margin[k + 1]) / 2)
    with torch.no_grad():
        model.logits.bias[blank] += shift
    print(f"  blank logit bias raised by {shift:.4f} (nearest frame margin "
          f"{float(gaps.max()) / 2:.3e} away)", flush=True)


def report_latency(np, what: str, lat: list, B: int, chunk_s: float) -> None:
    """Per-chunk step latency (host clock; each step ends by reading its
    ids back, which waits for the device) and the real-time factors."""
    ms = np.asarray(lat) * 1e3
    p50, p95 = float(np.percentile(ms, 50)), float(np.percentile(ms, 95))
    print(f"  latency {what}: per-chunk step p50 {p50:.3f} ms p95 {p95:.3f} ms over "
          f"{len(ms)} steps; one stream runs {chunk_s * 1e3 / p50:.1f}x real time, the batch "
          f"{B * chunk_s * 1e3 / float(np.mean(ms)):.1f} audio-s/s", flush=True)


def phase_daemon(torch, np, encoder: str = "cnn", rounds: int = 4) -> None:
    """The TCP serving daemon on localhost with 8 slots. Staggered: 8
    clients stream their utterances while a ninth is refused as busy.
    Sustained: 8 clients stream rounds - 1 utterances each, one connection
    per utterance, back to back, with the engine's tick statistics. Every
    final transcript equals the offline beam decode. Every socket and
    wait has a timeout."""
    import threading

    from uasr_torch.frontend.features import make_frontend_state
    from uasr_torch.models.models import build_model
    from uasr_torch.tools.serve_daemon import StreamClient, TickStats, create_server

    dev = torch.device(DEVICE)
    cfg = aishell_config(encoder)
    vocab = aishell_vocab()
    model = build_model(cfg.model, cfg.dim_output, cfg.frontend.dim_input,
                        generator=torch.Generator().manual_seed(SEED), device=dev)
    fstate = make_frontend_state(cfg.frontend, device=dev)
    batch = make_streams(np, cfg, DAEMON_SLOTS * rounds, SEED + 5)
    calibrate_blank(torch, cfg, model, fstate, batch, dev)
    cap = cfg.data.max_label_len
    ref = [r[:cap] for r in offline_ids(cfg, model, fstate, batch, vocab, dev, use_beam=True)]
    sr = cfg.frontend.sample_rate
    wait_s = 120.0
    server, engine = create_server(cfg, model, port=0, batch=DAEMON_SLOTS, device=dev)
    srv = threading.Thread(target=server.serve_forever, daemon=True)
    srv.start()
    host, port = server.server_address[:2]
    finals, errors = {}, []

    def stream(c, i):
        a = batch.audio[i, : batch.audio_lengths[i]]
        piece = 5120  # 0.32 s per message: the server re-chunks
        for off in range(0, len(a), piece):
            c.send_audio(a[off:off + piece])
        finals[i] = c.finish()

    def connect():
        """A started client; a refusal while a finished client's slot is
        being freed is retried."""
        deadline = time.perf_counter() + wait_s
        while True:
            c = StreamClient(host, port, timeout=wait_s)
            try:
                c.start()
                return c
            except RuntimeError:
                c.close()
                check(time.perf_counter() < deadline, "no daemon slot came free")
                time.sleep(0.001)

    def run_threads(fn):
        threads = [threading.Thread(target=fn, args=(i,), daemon=True)
                   for i in range(DAEMON_SLOTS)]
        for t in threads:
            t.start()
        return threads

    def join(threads, what):
        for t in threads:
            t.join(wait_s)
        check(not any(t.is_alive() for t in threads), f"{what}: a client did not finish")

    started = threading.Barrier(DAEMON_SLOTS + 1, timeout=wait_s)
    go = threading.Event()

    def staggered(i):
        try:
            c = StreamClient(host, port, timeout=wait_s)
            c.start()
            started.wait()
            check(go.wait(wait_s), "the clients were never released")
            time.sleep(0.02 * i)
            stream(c, i)
        except Exception as e:  # reported below, after the threads end
            errors.append(f"client {i}: {e!r}")
            started.abort()

    def sustained(i):
        try:
            for k in range(1, rounds):
                stream(connect(), i + k * DAEMON_SLOTS)
        except Exception as e:
            errors.append(f"client {i}: {e!r}")

    try:
        threads = run_threads(staggered)
        started.wait()  # every slot is held
        extra = StreamClient(host, port, timeout=wait_s)
        try:
            extra.start()
            refused = False
        except RuntimeError as e:
            refused = "busy" in str(e)
        extra.close()
        go.set()
        join(threads, "staggered")
        check(not errors, f"daemon clients failed: {errors}")
        engine.stats = TickStats()
        t0 = time.perf_counter()
        join(run_threads(sustained), "sustained")
        wall = time.perf_counter() - t0
        ts = engine.stats
    finally:
        server.shutdown()
        server.server_close()
        engine.stop()
        srv.join(wait_s)
    check(not errors, f"daemon clients failed: {errors}")
    check(refused, "the ninth client was not refused as busy")
    check(not srv.is_alive() and not engine._thread.is_alive(), "the daemon did not stop")
    bad = [i for i in range(len(ref)) if finals[i] != ref[i]]
    check(not bad, f"daemon finals {bad} differ from the offline beam decode")
    secs = float(np.sum(batch.audio_lengths[DAEMON_SLOTS:])) / sr
    n = DAEMON_SLOTS * (rounds - 1)
    print(f"daemon ({encoder}): {DAEMON_SLOTS} slots; {DAEMON_SLOTS} staggered clients with a ninth refused "
          f"busy, then {DAEMON_SLOTS} clients x {rounds - 1} utterances back to back; all "
          f"{len(ref)} finals == offline beam {cfg.ctc.beam_width}; sustained: {n} utterances, "
          f"{secs:.2f} s of audio in {wall:.3f} s, {secs / wall:.1f} audio-s/s", flush=True)
    ticks = max(ts.ticks, 1)
    print(f"  engine, sustained part: {ts.ticks} ticks, {ts.chunks / ticks:.2f} chunks and "
          f"{ts.live / ticks:.2f} live slots per tick (of {DAEMON_SLOTS}); idle "
          f"{ts.idle_s:.3f} s, batching window {ts.linger_s:.3f} s over {ts.lingers} waits, "
          f"ticks {ts.busy_s:.3f} s ({ts.busy_s / ticks * 1e3:.3f} ms per tick)", flush=True)


# the recurrent encoders (aishell_streaming with model.encoder=lc_bigru /
# uni_gru): H = 384, f32; 12 s -> 300 patches; lc_bigru's backward windows of
# lc_chunk + lc_lookahead = 24 patches, 19 per 12 s utterance folded into the
# batch; the attention encoders (librispeech with model.encoder=conformer /
# transformer): B = 32, T = 400 after the conv front, d = 512, 8 heads
K5_H, K5_T, K5_WINDOW, K5_WINDOWS = 384, 300, 24, 19
K6_B, K6_T, K6_HEADS, K6_DH = 32, 400, 8, 64
# a 33 s utterance: 825 encoder frames, padded to Tp = 832 (past the 552
# that K6 once kept whole in shared memory)
K6_LONG_T, LONG_SECONDS = 832, 33.0


def attention_problem(torch, gen, T: int):
    """K6's inputs at B=32, 8 x 64: keys of a row spread over the last
    quarter of T (a full row and a row with one valid key), q, k, v and a
    cotangent N(0, 1) in f32, the conformer-like bias N(0, 0.3^2) rounded
    to bf16."""
    dev = torch.device(DEVICE)
    B, D = K6_B, K6_HEADS * K6_DH
    lengths = torch.randint(3 * T // 4, T + 1, (B,), device=dev, generator=gen)
    lengths[0], lengths[1] = T, 1
    kmask = (torch.arange(T, device=dev)[None] < lengths[:, None]).to(torch.int32)[:, None]
    qkv = [torch.randn(B, T, D, device=dev, generator=gen) for _ in range(3)]
    dout = torch.randn(B, T, D, device=dev, generator=gen)
    bias = (0.3 * torch.randn(K6_HEADS, T, T, device=dev, generator=gen)).to(torch.bfloat16).float()
    return lengths, kmask, qkv, dout, bias


def sdpa_mask(torch, kmask, bias, dt):
    """The key mask (0 or -1e30) and the bias as one float mask [B, H or 1,
    T, T] for scaled_dot_product_attention, in dtype dt."""
    fmask = torch.where(kmask[:, :, None, :] > 0, 0.0, -1e30)
    if bias is not None:
        fmask = fmask + bias[None]
    return fmask.to(dt)


def phase_k5_k6(torch, np, results: dict) -> None:
    """K5 and K6 against their plain versions at the shapes the recurrent
    and attention paths give them, with their times, bounds and library
    yardsticks (cuDNN's unidirectional GRU for K5; scaled_dot_product_attention
    with the bias and key mask as one float mask for K6; neither is on any
    path)."""
    import torch.nn.functional as F

    from uasr_torch.models import cuda_gru as k5
    from uasr_torch.ops import cuda_attention as k6

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)

    # ---- K5: 12 s offline (T=300, B=64), the backward windows (T=24,
    # B=64*19), one streaming step's windows (T=24, B=64); ragged lengths,
    # and offline and at the windows also every row live for all T steps
    # (as cuDNN's yardstick runs, and as real lc_bigru windows nearly all are)
    H, B = K5_H, STREAM_B
    for what, T, rows in (("offline", K5_T, B), ("windows", K5_WINDOW, B * K5_WINDOWS),
                          ("step", K5_WINDOW, B)):
        ragged = torch.randint(0, T + 1, (rows,), device=dev, generator=gen)
        ragged[0] = T
        xp = 0.5 * torch.randn(T, 1, rows, 3 * H, device=dev, generator=gen)
        wh = torch.randn(1, H, 3 * H, device=dev, generator=gen) / H ** 0.5
        bh = 0.1 * torch.randn(1, 3 * H, device=dev, generator=gen)
        # cuDNN's unidirectional GRU on the same unmasked shapes (its input
        # projection from D = H included)
        gru = torch.nn.GRU(H, H).to(dev)
        gru.flatten_parameters()
        x = torch.randn(T, rows, H, device=dev, generator=gen)
        with torch.inference_mode():
            lib = cuda_ms(torch, lambda: gru(x), 20)
        for full in (False, True) if what != "step" else (False,):
            lengths = torch.full_like(ragged, T) if full else ragged
            tmask = (torch.arange(T, device=dev)[:, None] < lengths[None])[:, None]  # [T, 1, B]
            args = (xp, wh, bh, tmask)
            tag = f"{what}:full" if full else what
            got = k5.gru_scan_cuda(*args)
            plan = (k5.LAST_GRU_WH, *k5.LAST_GRU_PLAN)
            ref = k5.gru_scan_reference(*args)
            torch.cuda.synchronize()
            err = float((got - ref).abs().max())
            check(bool(torch.isfinite(got).all()), f"K5 {tag}: non-finite output")
            check(err <= 1e-4, f"K5 {tag}: max|d| {err:.3e} > 1e-4")
            check(not bool(got[:, 0, lengths == 0].any()), f"K5 {tag}: a zero-length row moved")
            ms = cuda_ms(torch, lambda: k5.gru_scan_cuda(*args), 20)
            plain = cuda_ms(torch, lambda: k5.gru_scan_reference(*args), 2)
            steps = int(lengths.sum())  # row-steps the masks keep active
            nbytes = 4 * (T * rows * 3 * H + H * 3 * H + 3 * H + T * rows * H) + 4 * T * rows
            bms, by = bound(nbytes, 2 * steps * H * 3 * H, "float32")
            print(f"K5 gru     {tag:12s} T={T} B={rows} H={H} (wh, units/CTA, splits)={plan}: "
                  f"max|d| {err:.3e} (tol 1e-4) kernel {ms:.4f} ms plain {plain:.4f} ms cuDNN "
                  f"GRU {lib:.4f} ms bound {bms:.4f} ms ({by})", flush=True)
            results[f"K5:{tag}"] = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
                                        bound_by=by, library_ms=lib)

    # ---- K6: B=32, T=400, 8 x 64, keys of a 12-16 s bucket, bf16 (and f32);
    # T=832 (a 33 s utterance), bf16 with the bias
    B, Hh, dh = K6_B, K6_HEADS, K6_DH
    problems = {T: attention_problem(torch, gen, T) for T in (K6_T, K6_LONG_T)}
    for what, T, dtype, with_bias in (("bias", K6_T, "bfloat16", True),
                                      ("nobias", K6_T, "bfloat16", False),
                                      ("f32", K6_T, "float32", True),
                                      ("bias:832", K6_LONG_T, "bfloat16", True)):
        lengths, kmask, qkv, _, bias = problems[T]
        b = bias if with_bias else None
        dt = getattr(torch, dtype)
        q, k, v = (x.to(dt).contiguous() for x in qkv)
        args = (q, k, v, b, kmask, Hh)
        out, lse = k6.mhsa_fwd_cuda(*args)
        r_out, r_lse = k6.mhsa_fwd_reference(*args)
        torch.cuda.synchronize()
        err = float((out.float() - r_out.float()).abs().max())
        lerr = float((lse - r_lse).abs().max())
        tol = 2e-2 if dtype == "bfloat16" else 1e-5
        check(bool(torch.isfinite(out.float()).all()), f"K6 {what}: non-finite output")
        check(err <= tol and lerr <= 1e-4, f"K6 {what}: out max|d| {err:.3e} > {tol} or lse "
                                           f"max|d| {lerr:.3e} > 1e-4")
        ms = cuda_ms(torch, lambda: k6.mhsa_fwd_cuda(*args), 20)
        plain = cuda_ms(torch, lambda: k6.mhsa_fwd_reference(*args), 5)
        esize = 2 if dtype == "bfloat16" else 4
        D = Hh * dh
        nbytes = (esize * 4 * B * T * D + (4 * Hh * T * T if b is not None else 0) + 4 * B * T
                  + 4 * B * Hh * T)
        keys = int(lengths.sum())  # every query row attends over its row's valid keys
        bms, by = bound(nbytes, 4 * Hh * dh * T * keys, dtype)
        # scaled_dot_product_attention on [B, heads, T, dh] with the bias and
        # the key mask as one float mask: one PyTorch call, same function
        qh, kh, vh = (x.view(B, T, Hh, dh).transpose(1, 2).contiguous() for x in (q, k, v))
        fmask = sdpa_mask(torch, kmask, b, dt)
        lib = cuda_ms(torch, lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=fmask),
                      20)
        print(f"K6 mhsa    {what:8s} B={B} T={T} heads={Hh} dh={dh} {dtype}: out max|d| "
              f"{err:.3e} (tol {tol}) lse max|d| {lerr:.3e} (tol 1e-4) kernel {ms:.4f} ms plain "
              f"{plain:.4f} ms SDPA {lib:.4f} ms bound {bms:.4f} ms ({by})", flush=True)
        results[f"K6:{what}"] = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
                                     bound_by=by, library_ms=lib)
        del fmask, out, r_out


def phase_recurrent_stream(torch, np, launches: dict) -> None:
    """The recurrent streaming path at full width: aishell_streaming with
    lc_bigru, then uni_gru, 64 streams of 1 to 12 s through
    StreamingRecognizer, greedy and beam 8, against the offline decode;
    launches per offline request and per step; latency at B = 64 and
    B = 8; a profile of one lc_bigru step.

    The streamed logits are not bit-equal to the offline ones: the forward
    GRUs step from a carried state through the plain loop, offline they run
    K5 from zero (as in the JAX package), so the logits differ in the last
    bits. Two checks separate the streaming machinery from that: the
    streamed beam finals equal the offline beam decode of the streamed
    path's own logits (carry, lag, flush and resumed beam exact), and those
    logits are within the encoder bar of the offline ones. The streams'
    seed is one where no beam decision of the 64 streams sits on a near-tie
    of that size (at seed offset 7 the beam final of one lc_bigru stream
    in 64 differs), so the finals also equal the offline decode."""
    from uasr_torch.frontend.features import compute_features, make_frontend_state
    from uasr_torch.models.models import build_model
    from uasr_torch.ops.decode import ctc_beam_search_decode
    from uasr_torch.serve import StreamingRecognizer

    dev = torch.device(DEVICE)
    vocab = aishell_vocab()
    zero = dict.fromkeys(_counters(), 0)
    for encoder in ("lc_bigru", "uni_gru"):
        cfg = aishell_config(encoder)
        L = cfg.model.num_gru_layers
        lc = encoder == "lc_bigru"
        model = build_model(cfg.model, cfg.dim_output, cfg.frontend.dim_input,
                            generator=torch.Generator().manual_seed(SEED), device=dev)
        fstate = make_frontend_state(cfg.frontend, device=dev)
        batch = make_streams(np, cfg, STREAM_B, SEED + 11)
        calibrate_blank(torch, cfg, model, fstate, batch, dev)
        rec = StreamingRecognizer(cfg, model, device=dev)
        chunk_s = rec.chunk_samples / cfg.frontend.sample_rate
        print(f"stream: {cfg.name} with {encoder} H={cfg.model.hidden_size} x{L}, "
              f"{cfg.model.dtype}, lc_chunk {cfg.model.lc_chunk} lookahead "
              f"{cfg.model.lc_lookahead}, V={cfg.dim_output}, beam {cfg.ctc.beam_width}, "
              f"{STREAM_B} streams, chunk {rec.chunk} frames, emission delay {rec.delay} chunks",
              flush=True)

        # offline references (--mode infer); each request runs K5 once per
        # GRU (lc_bigru: both directions of every layer)
        reset_launches()
        ref_greedy = offline_ids(cfg, model, fstate, batch, vocab, dev, use_beam=False)
        counts = read_launches()
        # the offline streaming-CMVN features run K7 once per chunk
        want_off = dict(zero, K7=counts["K7"], K5=(2 * L if lc else L))
        check(counts == want_off and counts["K7"] > 0,
              f"{encoder} offline launches {counts}, expected {want_off}")
        ref_beam = offline_ids(cfg, model, fstate, batch, vocab, dev, use_beam=True)
        cap = cfg.data.max_label_len
        print(f"  offline: greedy {np.mean([len(r) for r in ref_greedy]):.1f} tokens per "
              f"utterance, beam {np.mean([len(r) for r in ref_beam]):.1f}; launches per request "
              f"{counts}", flush=True)

        greedy = StreamingRecognizer(
            dataclasses.replace(cfg, ctc=dataclasses.replace(cfg.ctc, use_beam=False)), model,
            device=dev)
        want_greedy = dict(zero, K7=1, K5=(L if lc else 0))

        def greedy_step(d):
            check(d == want_greedy, f"{encoder} greedy step launches {d}, expected "
                                    f"{want_greedy}")

        part, tail, _, _ = stream_batch(torch, np, greedy, batch, greedy_step)
        got = [p + t for p, t in zip(part, tail)]
        bad = [b for b in range(STREAM_B) if got[b] != ref_greedy[b]]
        print(f"  greedy: streamed == offline for {STREAM_B - len(bad)} of {STREAM_B} streams",
              flush=True)
        check(not bad, f"{encoder} greedy streams {bad[:8]} differ from the offline decode")

        want = dict(want_greedy, K4=1)
        steps = 0

        def beam_step(d):
            nonlocal steps
            steps += 1
            check(d == want, f"{encoder} beam step launches {d}, expected {want}")

        step_logits = []
        model_step = model.step

        def spy(*args):
            out = model_step(*args)
            step_logits.append(out[0])
            return out

        model.step = spy
        reset_launches()
        try:
            _, final, lat, _ = stream_batch(torch, np, rec, batch, beam_step)
        finally:
            counts = read_launches()
            del model.step
        flush = rec.delay  # finish's zero-input steps
        want_run = dict(zero, K7=steps, K5=(L * (steps + flush) if lc else 0), K4=steps + flush)
        print(f"  beam: {steps} steps + finish ({flush} flush steps), launches {counts}",
              flush=True)
        check(counts == want_run, f"{encoder} beam path launches {counts}, expected {want_run}")
        if lc:
            launches.update({"K5": counts["K5"]})
        # the streamed logits (lc_bigru's first `delay` steps emit nothing)
        # against the offline ones, and the offline beam over them
        audio = torch.as_tensor(batch.audio, device=dev)
        alen = torch.as_tensor(batch.audio_lengths, device=dev, dtype=torch.long)
        with torch.inference_mode():
            off_logits, n = model(*compute_features(audio, alen, fstate, cfg.frontend))
            st_logits = torch.cat(step_logits[rec.delay:], 1)[:, : off_logits.shape[1]]
            valid = torch.arange(off_logits.shape[1], device=dev)[None] < n[:, None]
            dlog = float((st_logits - off_logits).abs().amax(-1)[valid].max())
            hyp, hlen, _ = ctc_beam_search_decode(st_logits, n, cfg.ctc.beam_width,
                                                  cfg.ctc.blank_id)
        hyp, hlen = hyp.cpu().numpy(), hlen.cpu().numpy()
        own = [hyp[b, : hlen[b]].tolist()[:cap] for b in range(STREAM_B)]
        bad = [b for b in range(STREAM_B) if final[b] != own[b]]
        print(f"  streamed logits vs offline: max|d| {dlog:.3e} (tol 1e-4); beam finals == "
              f"offline beam of the streamed logits for {STREAM_B - len(bad)} of {STREAM_B} "
              f"streams", flush=True)
        check(dlog <= 1e-4, f"{encoder} streamed logits max|d| {dlog:.3e} > 1e-4")
        check(not bad, f"{encoder} beam streams {bad[:8]} differ from the beam decode of their "
                       "own logits")
        bad = [b for b in range(STREAM_B) if final[b] != ref_beam[b][:cap]]
        print(f"  beam: finish == offline beam {cfg.ctc.beam_width} for {STREAM_B - len(bad)} of "
              f"{STREAM_B} streams", flush=True)
        check(not bad, f"{encoder} beam streams {bad[:8]} differ from the offline beam decode")
        report_latency(np, f"{encoder} B={STREAM_B}", lat[1:], STREAM_B, chunk_s)
        small = make_streams(np, cfg, DAEMON_SLOTS, SEED + 8)
        _, _, lat8, _ = stream_batch(torch, np, rec, small)
        report_latency(np, f"{encoder} B={DAEMON_SLOTS}", lat8[1:], DAEMON_SLOTS, chunk_s)
        if lc:
            st = rec.init(STREAM_B, batch.audio_lengths)
            cs = rec.chunk_samples
            mid = batch.audio.shape[1] // cs // 2
            for k in range(mid):
                st, _, _ = rec.step(st, batch.audio[:, k * cs:(k + 1) * cs])

            def one_step():
                rec.step(st, batch.audio[:, mid * cs:(mid + 1) * cs])[1].cpu()

            profile_call(torch, one_step, f"one lc_bigru streaming step of {STREAM_B} streams")


def attention_config(encoder: str, vocab_size: int):
    """configs/librispeech_ctc_bigru.yaml's decode settings (recipe_config)
    with ``model.encoder`` set to an attention encoder and ``attn_pallas``
    on; the other settings are ModelConfig's defaults: 4 blocks, 8 heads,
    FFN 4 x 512, conformer kernel 15 and relative clip 64."""
    cfg = recipe_config(vocab_size)
    return cfg.replace(model=dataclasses.replace(cfg.model, encoder=encoder, attn_pallas=True))


def phase_attention(torch, np, launches: dict) -> None:
    """The attention decode path at full width: run_inference with the
    conformer and the transformer on the four bucket requests (beam 16) and
    the conformer on a request of 4 utterances up to 33 s, transformer_layers
    K6 per request, and the 16 s (and 33 s) request's logits on the kernel
    path against the plain path."""
    from uasr_torch import infer
    from uasr_torch.frontend.features import compute_features, make_frontend_state
    from uasr_torch.models.models import build_model

    dev = torch.device(DEVICE)
    vocab = char_vocab()
    for encoder in ("conformer", "transformer"):
        cfg = attention_config(encoder, len(vocab))
        model = build_model(cfg.model, cfg.dim_output, cfg.frontend.dim_input,
                            generator=torch.Generator().manual_seed(SEED), device=dev)
        if encoder == "conformer":
            # flax starts the relative-position tables at zero; draw them so
            # the bias path carries real values
            gen = torch.Generator().manual_seed(SEED + 9)
            with torch.no_grad():
                for i in range(cfg.model.transformer_layers):
                    t = getattr(model, f"rel_bias{i}")
                    t.copy_(0.3 * torch.randn(t.shape, generator=gen))
        fstate = make_frontend_state(cfg.frontend, device=dev)
        requests = make_requests(np, cfg)
        if encoder == "conformer":
            # and one request of 4 utterances up to 33 s: Tp = 832 through K6
            requests.append(make_request(np, np.random.RandomState(SEED + 33), cfg, 4,
                                         LONG_SECONDS))
        print(f"attention: {cfg.name} with {encoder}, d={cfg.model.hidden_size} "
              f"{cfg.model.num_heads} heads x{cfg.model.transformer_layers}, {cfg.model.dtype}, "
              f"V={cfg.dim_output}, beam {cfg.ctc.beam_width}, {len(requests)} requests of B="
              f"{[b.audio.shape[0] for b in requests]}", flush=True)
        infer.run_inference(cfg, model, fstate, requests[:1], vocab=vocab, device=dev)
        total = dict.fromkeys(_counters(), 0)
        want = dict(total, K1=1, K4=1, K6=cfg.model.transformer_layers)
        for b in requests:
            reset_launches()
            r = infer.run_inference(cfg, model, fstate, [b], vocab=vocab, device=dev)
            counts = read_launches()
            wall = r["rtf"] * r["audio_seconds"]
            check(counts == want, f"{encoder} request launches {counts}, expected {want}")
            check(np.isfinite(r["per"]) and infer.LAST_BEAM_IMPL == "cuda", f"{encoder}: {r}")
            print(f"  {encoder} request B={b.audio.shape[0]} {b.audio.shape[1] / 16000:5.1f} s: "
                  f"wall {wall * 1e3:.2f} ms, {r['audio_seconds'] / wall:.1f} audio-s/s, PER "
                  f"{r['per']:.3f}, launches {counts}", flush=True)
            for k, v in counts.items():
                total[k] += v
        if encoder == "conformer":
            launches.update({"K6": total["K6"]})
            profile_call(torch, lambda: infer.run_inference(cfg, model, fstate, requests[3:4],
                                                            vocab=vocab, device=dev),
                         "one 16 s conformer request")
        # the 16 s request's logits (and the conformer's 33 s request's) on
        # the kernel path against the plain path
        for b, T in ((requests[3], K6_T), *(((requests[4], 825),) if len(requests) > 4 else ())):
            audio = torch.as_tensor(b.audio, device=dev)
            alen = torch.as_tensor(b.audio_lengths, device=dev, dtype=torch.long)

            def logits():
                with torch.inference_mode():
                    return model(*compute_features(audio, alen, fstate, cfg.frontend))

            lk, nk = logits()
            with plain_versions():
                lp, npl = logits()
            check(lk.shape == (b.audio.shape[0], T, cfg.dim_output),
                  f"{encoder} logits shape {tuple(lk.shape)}")
            check(bool(torch.isfinite(lk).all()) and bool(torch.equal(nk, npl)),
                  f"{encoder}: non-finite logits or lengths differ")
            err = float((lk - lp).abs().max())
            check(err <= 5e-2, f"{encoder} T={T}: kernel-path logits max|d| {err:.3e} > 5e-2")
            print(f"  {encoder} logits T={T} kernel path vs plain path, bf16: max|d| {err:.3e} "
                  f"(tol 5e-2)", flush=True)


def _gru_problem(torch, gen, T: int, rows: int, H: int, dt, full: bool = False):
    """K5's inputs at one group with ragged lengths (a full row, a row of
    length 0), or every row live for all T steps (`full`), and a cotangent
    of ys."""
    dev = torch.device(DEVICE)
    lengths = torch.randint(0, T + 1, (rows,), device=dev, generator=gen)
    lengths[0], lengths[-1] = T, 0
    if full:
        lengths.fill_(T)
    tmask = (torch.arange(T, device=dev)[:, None] < lengths[None])[:, None]  # [T, 1, B]
    xp = 0.5 * torch.randn(T, 1, rows, 3 * H, device=dev, generator=gen)
    wh = torch.randn(1, H, 3 * H, device=dev, generator=gen) / H ** 0.5
    bh = 0.1 * torch.randn(1, 3 * H, device=dev, generator=gen)
    dy = torch.randn(T, 1, rows, H, device=dev, generator=gen) / rows
    return tuple(x.to(dt).contiguous() for x in (xp, wh, bh)), tmask, dy.to(dt), lengths


def gru_bwd_case(torch, gen, what: str, T: int, rows: int, H: int, dtype: str,
                 full: bool = False) -> tuple:
    """K5's coefficient outputs, K5-bwd (its coefficient kernel also alone)
    and K8 at one shape against their plain versions, with their times,
    bounds and cuDNN's GRU backward on the same shape. Returns the K5-bwd
    and K8 result rows."""
    from uasr_torch.models import cuda_gru as k5

    dev = torch.device(DEVICE)
    dt = getattr(torch, dtype)
    args, tmask, dy, lengths = _gru_problem(torch, gen, T, rows, H, dt, full)
    ys, c4, ch = k5.gru_scan_cuda(*args, tmask, save_coeffs=True)
    r_ys, r_c4, r_ch = k5.gru_scan_reference(*args, tmask, save_coeffs=True)
    got = k5.gru_scan_bwd_cuda(*args, tmask, ys, dy)
    plan = (k5.LAST_GRU_BWD_WH, *k5.LAST_GRU_BWD_PLAN)
    ref = k5.gru_scan_bwd_reference(*args, tmask, ys, dy)
    bc4, bch = k5.gru_bwd_coeffs_cuda(*args, tmask, ys)
    r_bc4, r_bch = k5.gru_bwd_coeffs_reference(*args, tmask, ys)
    lin = k5.gru_scan_bwd_lin_cuda(c4, ch, dy, args[1])
    plan_l = (k5.LAST_GRU_BWD_WH, *k5.LAST_GRU_BWD_PLAN)
    r_lin = k5.gru_scan_bwd_lin_reference(c4, ch, dy, args[1])
    torch.cuda.synchronize()
    # K2-bwd's bars: f32 1e-4, bf16 one bf16 ulp (2^-7) of the largest
    # reference value; K5's coefficients follow each side's own carry,
    # which in bf16 may round an ulp apart (K5's bf16 bar); the backward's
    # coefficient kernel reads the same ys as its plain version: f32 1e-5
    tol = 1e-4 if dtype == "float32" else 2 ** -7
    c_err = max(float((a.float() - r.float()).abs().max()) / max(
        1.0, float(r.float().abs().max())) for a, r in ((c4, r_c4), (ch, r_ch)))
    bc_err = max(float((a - r).abs().max()) for a, r in ((bc4, r_bc4), (bch, r_bch)))
    bc_tol = 1e-5 if dtype == "float32" else 2 ** -7 * float(r_bc4.abs().max())
    scale = max(float(r.float().abs().max()) for r in ref)
    err = max(float((a.float() - r.float()).abs().max()) for a, r in zip(got, ref))
    l_scale = float(r_lin.float().abs().max())
    l_err = float((lin.float() - r_lin.float()).abs().max())
    zero = lengths == 0
    tag = f"{what}:full" if full else what
    print(f"K5-bwd/K8  {tag:13s} {dtype:8s} T={T} B={rows} H={H} (wh, units/CTA, splits) K5-bwd "
          f"{plan} K8 {plan_l}: K5 coefficients max|d|/max(1,|ref|) {c_err:.3e}; K5-bwd "
          f"coefficient kernel max|d| {bc_err:.3e} (tol {bc_tol:.3e}); K5-bwd max|d| "
          f"{err:.3e}, K8 {l_err:.3e}, largest |ref| {scale:.3e} / {l_scale:.3e} "
          f"(tol {tol} x)", flush=True)
    check(all(bool(torch.isfinite(a.float()).all()) for a in (*got, lin, c4, ch, bc4, bch)),
          f"K5-bwd/K8 {tag} {dtype}: non-finite output")
    check(c_err <= tol, f"K5 coefficients {tag} {dtype}: {c_err:.3e} > {tol}")
    check(bc_err <= bc_tol, f"K5-bwd coefficient kernel {tag} {dtype}: {bc_err:.3e}")
    check(err <= tol * max(scale, 1.0), f"K5-bwd {tag} {dtype}: max|d| {err:.3e}")
    check(l_err <= tol * max(l_scale, 1.0), f"K8 {tag} {dtype}: max|d| {l_err:.3e}")
    check(not any(bool(t[:, 0, zero].any()) for t in (*got, lin)),
          f"K5-bwd/K8 {tag} {dtype}: a zero-length row got a gradient")
    ms = cuda_ms(torch, lambda: k5.gru_scan_bwd_cuda(*args, tmask, ys, dy), 10)
    ms_c = cuda_ms(torch, lambda: k5.gru_bwd_coeffs_cuda(*args, tmask, ys), 10)
    ms_l = cuda_ms(torch, lambda: k5.gru_scan_bwd_lin_cuda(c4, ch, dy, args[1]), 10)
    plain = cuda_ms(torch, lambda: k5.gru_scan_bwd_reference(*args, tmask, ys, dy), 1)
    plain_l = cuda_ms(torch, lambda: k5.gru_scan_bwd_lin_reference(c4, ch, dy, args[1]), 1)
    es = 4 if dtype == "float32" else 2
    steps = int(lengths.sum())  # row-steps the masks keep active
    TB = T * rows
    nbytes = es * (TB * 3 * H + H * 3 * H + 3 * H + 2 * TB * H + TB * 3 * H + TB * H) + 4 * TB
    bms, by = bound(nbytes, 2 * 2 * steps * H * 3 * H, dtype)
    nbytes_l = es * (TB * 4 * H + TB * H + H * 3 * H + TB * 4 * H) + 4 * TB * H
    bms_l, by_l = bound(nbytes_l, 2 * steps * H * 3 * H, dtype)
    # cuDNN's unidirectional GRU on the same unmasked shapes (input D = H):
    # forward + backward minus forward
    gru = torch.nn.GRU(H, H).to(device=dev, dtype=dt)
    gru.flatten_parameters()
    x = torch.randn(T, rows, H, device=dev, generator=gen).to(dt).requires_grad_()
    gy = torch.randn(T, rows, H, device=dev, generator=gen).to(dt)
    fwd = cuda_ms(torch, lambda: gru(x)[0], 10)
    lib = cuda_ms(torch, lambda: gru(x)[0].backward(gy), 10) - fwd
    print(f"  K5-bwd kernel {ms:.4f} ms (coefficient kernel alone {ms_c:.4f}) plain "
          f"{plain:.4f} ms bound {bms:.4f} ms ({by}); K8 kernel {ms_l:.4f} ms plain "
          f"{plain_l:.4f} ms bound {bms_l:.4f} ms ({by_l}); cuDNN GRU bwd {lib:.4f} ms (fwd "
          f"{fwd:.4f}); live row-steps {steps} of {TB}", flush=True)
    return (dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
                 library_ms=lib),
            dict(max_abs_err=l_err, ms=ms_l, plain_ms=plain_l, bound_ms=bms_l, bound_by=by_l,
                 library_ms=lib))


def phase_train_k5_k6(torch, np, results: dict) -> None:
    """K5's coefficient outputs, K5-bwd and K8 at the recurrent encoders'
    training shapes and K6-bwd at the attention encoders', against their
    plain versions, with their times, bounds and library yardsticks (cuDNN's
    unidirectional GRU and scaled_dot_product_attention, each forward +
    backward minus forward; neither is on any path)."""
    import torch.nn.functional as F

    from uasr_torch.ops import cuda_attention as k6

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)

    # ---- K5-bwd, K8: the 12 s forward GRU of lc_bigru and uni_gru (T=300,
    # B=64) and the lc_bigru backward windows (T=24, B=64*19), H=384; ragged
    # lengths (about half the row-steps live) in f32 and bf16, and in f32
    # with every row live for all T steps, as cuDNN always runs and as real
    # lc_bigru windows nearly all are
    for what, T, rows in (("offline", K5_T, STREAM_B), ("windows", K5_WINDOW,
                                                        STREAM_B * K5_WINDOWS)):
        for dtype, full in (("float32", False), ("bfloat16", False), ("float32", True)):
            res, res_l = gru_bwd_case(torch, gen, what, T, rows, K5_H, dtype, full)
            key = f"{what}:full" if full else f"{what}:{dtype}"
            results[f"K5-bwd:{key}"], results[f"K8:{key}"] = res, res_l

    # ---- K6-bwd: B=32, T=400, 8 x 64, keys of a 12-16 s bucket; T=832
    B, Hh, dh = K6_B, K6_HEADS, K6_DH
    problems = {T: attention_problem(torch, gen, T) for T in (K6_T, K6_LONG_T)}
    for what, T, dtype, with_bias in (("bias", K6_T, "bfloat16", True),
                                      ("nobias", K6_T, "bfloat16", False),
                                      ("f32", K6_T, "float32", True),
                                      ("bias:832", K6_LONG_T, "bfloat16", True)):
        lengths, kmask, qkv, doutf, bias = problems[T]
        b = bias if with_bias else None
        dt = getattr(torch, dtype)
        q, k, v = (x.to(dt).contiguous() for x in qkv)
        out, lse = k6.mhsa_fwd_cuda(q, k, v, b, kmask, Hh)
        dout = doutf.to(dt)
        args = (q, k, v, b, kmask, out, lse, dout, Hh)
        got = k6.mhsa_bwd_cuda(*args)
        again = k6.mhsa_bwd_cuda(*args)
        ref = k6.mhsa_bwd_reference(*args)
        torch.cuda.synchronize()
        # relative to each tensor's largest magnitude: bf16 2e-2 (p and t
        # round to bf16 before their products), f32 1e-4
        rel = 2e-2 if dtype == "bfloat16" else 1e-4
        errs = [float((a.float() - r.float()).abs().max()) / float(r.float().abs().max())
                for a, r in zip(got, ref) if r is not None]
        err = max(float((a.float() - r.float()).abs().max()) for a, r in zip(got, ref)
                  if r is not None)
        same = b is None or bool(torch.equal(got[3], again[3]))
        print(f"K6-bwd     {what:8s} B={B} T={T} heads={Hh} dh={dh} {dtype}: max|d|/max|ref| "
              f"dq {errs[0]:.3e} dk {errs[1]:.3e} dv {errs[2]:.3e}"
              + (f" d_bias {errs[3]:.3e}, bit-equal over two launches: {same}"
                 if b is not None else "") + f" (tol {rel})", flush=True)
        check(all(bool(torch.isfinite(a.float()).all()) for a in got if a is not None),
              f"K6-bwd {what}: non-finite output")
        check(max(errs) <= rel, f"K6-bwd {what}: max|d|/max|ref| {max(errs):.3e} > {rel}")
        check(same, f"K6-bwd {what}: d_bias differs between two launches")
        ms = cuda_ms(torch, lambda: k6.mhsa_bwd_cuda(*args), 10)
        plain = cuda_ms(torch, lambda: k6.mhsa_bwd_reference(*args), 2)
        es = 2 if dtype == "bfloat16" else 4
        D = Hh * dh
        nbytes = (es * 8 * B * T * D + (2 * 4 * Hh * T * T if b is not None else 0) + 4 * B * T
                  + 4 * B * Hh * T)
        keys = int(lengths.sum())  # every query row attends over its row's valid keys
        bms, by = bound(nbytes, 10 * Hh * dh * T * keys, dtype)
        # scaled_dot_product_attention with the bias and key mask as one
        # float mask: forward + backward (dq, dk, dv) minus forward
        qh, kh, vh = (x.view(B, T, Hh, dh).transpose(1, 2).contiguous().requires_grad_()
                      for x in (q, k, v))
        gh = dout.view(B, T, Hh, dh).transpose(1, 2).contiguous()
        fmask = sdpa_mask(torch, kmask, b, dt)

        def sdpa():
            return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=fmask)

        fwd = cuda_ms(torch, sdpa, 10)
        lib = cuda_ms(torch, lambda: sdpa().backward(gh), 10) - fwd
        print(f"  K6-bwd kernel {ms:.4f} ms plain {plain:.4f} ms SDPA bwd {lib:.4f} ms (fwd "
              f"{fwd:.4f}) bound {bms:.4f} ms ({by})", flush=True)
        results[f"K6-bwd:{what}"] = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
                                         bound_by=by, library_ms=lib)
        del fmask, got, again, ref, qh, kh, vh


def encoder_train_config(encoder: str):
    """The training configurations of the four encoders: aishell_streaming
    with lc_bigru / uni_gru (gru_pallas, ctc.use_pallas; H=384, f32, B=64,
    buckets 4, 8, 12 s, V=4233 stand-in) and librispeech_ctc_bigru with
    conformer / transformer (attn_pallas; d=512, bf16, B=32, 4-16 s, the
    recipe's SpecAugment, clip and schedule, V=32 stand-in)."""
    if encoder in ("lc_bigru", "uni_gru"):
        cfg = aishell_config(encoder)
        return cfg.replace(ctc=dataclasses.replace(cfg.ctc, use_pallas=True))
    return attention_config(encoder, len(char_vocab()))


def phase_encoder_train(torch, np, launches: dict) -> None:
    """The training paths of the recurrent and attention encoders at full
    width through CTCTrainer: a set-up step, then one step per bucket with
    its exact launch counts, one lc_bigru step with the linear backward,
    a profile of one 12 s (lc_bigru) and one 16 s (conformer, transformer)
    step, and the
    first step's loss and gradients on the kernel path against the plain
    path."""
    from uasr_torch import train
    from uasr_torch.models import cuda_gru

    dev = torch.device(DEVICE)
    zero = dict.fromkeys(_counters(), 0)
    total = dict(zero)
    for encoder in ("lc_bigru", "uni_gru", "conformer", "transformer"):
        cfg = encoder_train_config(encoder)
        m = cfg.model
        recurrent = encoder in ("lc_bigru", "uni_gru")
        trainer = train.CTCTrainer(cfg, device=dev)
        state = trainer.init_state()
        if encoder == "conformer":
            # flax starts the relative-position tables at zero; draw them so
            # d_bias is not fed by a zero bias
            gen = torch.Generator().manual_seed(SEED + 13)
            with torch.no_grad():
                for i in range(m.transformer_layers):
                    t = state.params[f"rel_bias{i}"]
                    t.copy_(0.3 * torch.randn(t.shape, generator=gen).to(t.device))
        init_params = {k: v.detach().clone() for k, v in state.params.items()}
        batches = make_requests(np, cfg, cps=4 if recurrent else 14)
        sr = cfg.frontend.sample_rate
        print(f"train: {cfg.name} with {encoder}, "
              + (f"H={m.hidden_size} x{m.num_gru_layers} GRU layers" if recurrent else
                 f"d={m.hidden_size} {m.num_heads} heads x{m.transformer_layers}")
              + f", {m.dtype}, V={cfg.dim_output}, B={cfg.data.batch_size}, buckets "
              f"{cfg.data.bucket_boundaries}, {cfg.train.lr_schedule} lr {cfg.train.lr}, clip "
              f"{cfg.train.grad_clip}, SpecAugment {cfg.frontend.specaug_freq_masks} x "
              f"{cfg.frontend.specaug_freq_mask} + {cfg.frontend.specaug_time_masks} x "
              f"{cfg.frontend.specaug_time_mask}", flush=True)

        def step(b):
            nonlocal state
            state, aux = trainer.train_step(state, b)
            return float(aux["loss"]), float(aux["grad_norm"])

        def want_of(b, linear=False):
            """Launches of one step, from the code: lc_bigru runs a forward
            GRU and a backward-window GRU per layer, uni_gru one GRU per
            layer, each one K5 forward and one K5-bwd (or K8); an attention
            encoder one K6 and one K6-bwd per block; one K3 and one K3-bwd;
            the streaming-CMVN frontend one K7 per 64-frame chunk of the
            padded audio, the utterance-CMVN one K1."""
            if recurrent:
                grus = (2 if encoder == "lc_bigru" else 1) * m.num_gru_layers
                chunk = cfg.frontend.streaming_chunk_frames * cfg.frontend.frame_shift
                fused = {"K5-bwd": grus, "K5-bwd:coeffs": grus}  # a chain and its coefficients
                return dict(zero, K7=-(-b.audio.shape[1] // chunk), K5=grus, K3=1, **{
                    "K3-bwd": 1, **({"K8": grus} if linear else fused)})
            return dict(zero, K1=1, K6=m.transformer_layers, K3=1,
                        **{"K6-bwd": m.transformer_layers, "K3-bwd": 1})

        t0 = time.perf_counter()
        loss, gnorm = step(batches[-1])
        torch.cuda.synchronize()
        print(f"  set-up step ({batches[-1].audio.shape[1] / sr:.0f} s bucket): wall "
              f"{(time.perf_counter() - t0) * 1e3:.2f} ms, loss {loss:.4f}, grad_norm "
              f"{gnorm:.4f}", flush=True)
        for b in batches:
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, gnorm = step(b)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = read_launches()
            secs = float(np.sum(b.audio_lengths)) / sr
            print(f"  step {state.step} {b.audio.shape[1] / sr:5.1f} s bucket: wall "
                  f"{wall * 1e3:.2f} ms, {secs / wall:.1f} audio-s/s, loss {loss:.4f}, "
                  f"grad_norm {gnorm:.4f}, launches {counts}", flush=True)
            check(np.isfinite(loss) and loss > 0 and np.isfinite(gnorm),
                  f"{encoder} step {state.step}: loss {loss} grad_norm {gnorm}")
            want = want_of(b)
            check(counts == want, f"{encoder} step {state.step}: launches {counts}, "
                                  f"expected {want}")
            for k, v in counts.items():
                total[k] += v
        if encoder == "lc_bigru":
            # the linear backward: K5 saves the coefficients, K8 runs the chain
            b = batches[-1]
            saved = cuda_gru.BWD_IMPL
            cuda_gru.BWD_IMPL = "linear"
            try:
                reset_launches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                loss, gnorm = step(b)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                counts = read_launches()
            finally:
                cuda_gru.BWD_IMPL = saved
            secs = float(np.sum(b.audio_lengths)) / sr
            print(f"  step {state.step} {b.audio.shape[1] / sr:5.1f} s bucket, linear backward "
                  f"(K8): wall {wall * 1e3:.2f} ms, {secs / wall:.1f} audio-s/s, loss "
                  f"{loss:.4f}, grad_norm {gnorm:.4f}, launches {counts}", flush=True)
            check(np.isfinite(loss) and np.isfinite(gnorm), f"linear step: loss {loss}")
            want = want_of(b, linear=True)
            check(counts == want, f"linear step: launches {counts}, expected {want}")
            launches["K8"] = counts["K8"]
        check(all(bool(torch.isfinite(p).all()) for p in state.params.values()),
              f"{encoder}: non-finite parameters after training")
        if encoder in ("lc_bigru", "conformer", "transformer"):
            profile_call(torch, lambda: step(batches[-1]),
                         f"one {batches[-1].audio.shape[1] / sr:.0f} s {encoder} training step")
        compare_first_step(torch, cfg, init_params, trainer.to_device(batches[-1]),
                           f"{encoder} step", floor=1e-2)
    launches.update({k: total[k] for k in ("K5-bwd", "K6-bwd")})



# ------------------------------------------------------- unsupervised path

# the formant corpora of the full-width phases, cut to this many
# utterances (the recipes ask for 2048): enough for every batch they draw
UNSUP_UTTS = 256
UNSUP_STEPS = 4  # timed gan+eodm alternations at full width
UNSUP_WGAN_V = 62  # a 61-phone TIMIT list with the blank; stand-in vocabulary
DEMO_PER_BAR = 0.65  # the JAX package's own bar for the demo (chance ~0.83)


def unsup_corpus(cfg, n: int, seed: int = 0):
    """The recipe's synthetic corpus (``data.synthetic_*``), ``n``
    utterances: (examples, vocab)."""
    from uasr_torch.data.dataset import make_synthetic_dataset

    d = cfg.data
    return make_synthetic_dataset(num_utts=n, num_phones=cfg.dim_output - 2, seed=seed,
                                  syntax=d.synthetic_syntax, min_len=d.synthetic_min_len,
                                  max_len=d.synthetic_max_len, style=d.synthetic_style)


def unsup_batches(cfg, examples, seed: int):
    from uasr_torch.data.dataset import batch_iterator

    return batch_iterator(examples, cfg.data.batch_size,
                          int(cfg.data.max_audio_seconds * cfg.frontend.sample_rate),
                          cfg.data.max_label_len, seed=seed)


def copy_state(torch, state):
    """A GANState whose tensors are copies (the trainers update in place)."""
    def cp(tree):
        if isinstance(tree, dict):
            return {k: cp(v) for k, v in tree.items()}
        return tree.detach().clone() if isinstance(tree, torch.Tensor) else tree

    return type(state)(*(cp(x) for x in state))


def alternation(trainer, state, audio, text_it):
    """``gan.disc_steps`` critic steps, then one generator step: (state, aux)."""
    for k in range(trainer.cfg.gan.disc_steps):
        state, d_aux = trainer.d_step(state, next(audio), next(text_it),
                                      generator=trainer.eps_generator(state.step, k))
    state, g_aux = trainer.g_step(state, next(audio))
    return state, {k: float(v) for k, v in {**d_aux, **g_aux}.items()}


def phase_unsup_full(torch, np) -> None:
    """configs/formant39_unsup.yaml at full width (classifier 384 x 2,
    context 4, V = 41; critic 256 x 3; bce with merge_repeats, diversity
    and smoothness; EODM orders 1 and 2, top-k 600; B = 32 at 6 s):
    GANTrainer's gan+eodm alternations, the first one's losses on the
    kernel path against the plain path from the same state, batches and
    draws, then a set-up alternation and UNSUP_STEPS timed ones with their
    launch counts (K1 once per step), and a profile of one."""
    from uasr_torch import train
    from uasr_torch.config import load_config
    from uasr_torch.data.dataset import text_batch_iterator
    from uasr_torch.ops.eodm import device_ngram_tables

    dev = torch.device(DEVICE)
    cfg = load_config(os.path.join(REPO, "configs", "formant39_unsup.yaml"))
    examples, vocab = unsup_corpus(cfg, UNSUP_UTTS)
    check(len(vocab) == cfg.dim_output, f"vocabulary of {len(vocab)}")
    text = [ids for _, ids in examples]
    tables = device_ngram_tables(cfg.eodm, text, dev)
    trainer = train.GANTrainer(cfg, device=dev, tables=tables)
    m, g = cfg.model, cfg.gan
    print(f"unsup: {cfg.name} classifier {m.classifier_hidden} x {m.classifier_layers} context "
          f"{m.classifier_context}, critic {m.disc_channels} x {m.disc_layers}, V="
          f"{cfg.dim_output}, {g.objective}, merge {g.merge_repeats}, EODM orders "
          f"{list(cfg.eodm.ngram_orders)} top-k {cfg.eodm.top_k} ({[len(t[0]) for t in tables]}"
          f" kept), B={cfg.data.batch_size} at {cfg.data.max_audio_seconds} s, "
          f"{g.disc_steps} critic steps per generator step; {UNSUP_UTTS} formant utterances",
          flush=True)
    audio = unsup_batches(cfg, examples, cfg.train.seed)
    text_it = text_batch_iterator(text, cfg.data.batch_size, cfg.data.max_label_len,
                                  seed=cfg.train.seed)

    # the first alternation from the same state, batches and draws on both
    # paths (K1's features differ from the plain version's within 1e-4)
    state0 = trainer.init_state()
    batches = [next(audio) for _ in range(g.disc_steps + 1)]
    texts = [next(text_it) for _ in range(g.disc_steps)]
    got = {}
    for path in ("kernel", "plain"):
        ctx = plain_versions() if path == "plain" else contextlib.nullcontext()
        with ctx:
            _, got[path] = alternation(trainer, copy_state(torch, state0), iter(batches),
                                       iter(texts))
    for name, v in got["kernel"].items():
        p = got["plain"][name]
        print(f"  first step, kernel path vs plain path: {name} {v:.6f} vs {p:.6f} (rel "
              f"{_rel(v, p):.3e}, tol 1e-3)", flush=True)
        check(math.isfinite(v) and _rel(v, p) <= 1e-3, f"unsup first step {name}: {v} vs {p}")

    state = trainer.init_state()
    t0 = time.perf_counter()
    state, aux = alternation(trainer, state, audio, text_it)
    torch.cuda.synchronize()
    print(f"  set-up alternation: wall {(time.perf_counter() - t0) * 1e3:.2f} ms", flush=True)
    walls = []
    reset_launches()
    for _ in range(UNSUP_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, aux = alternation(trainer, state, audio, text_it)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        print(f"  step {state.step}: wall {walls[-1] * 1e3:.2f} ms, "
              + ", ".join(f"{k} {v:.4f}" for k, v in aux.items()), flush=True)
        check(all(math.isfinite(v) for v in aux.values()), f"step {state.step}: {aux}")
    counts = read_launches()
    print(f"  launches over {UNSUP_STEPS} alternations: {counts}", flush=True)
    want = dict.fromkeys(counts, 0)
    want["K1"] = UNSUP_STEPS * (g.disc_steps + 1)
    check(counts == want, f"gan+eodm launches {counts}, expected {want}")
    secs = cfg.data.batch_size * (g.disc_steps + 1) * cfg.data.max_audio_seconds
    print(f"  step wall (one alternation: {g.disc_steps} critic steps + 1 generator step) mean "
          f"{np.mean(walls) * 1e3:.2f} ms, min {min(walls) * 1e3:.2f} ms; "
          f"{secs / np.mean(walls):.1f} padded audio-s/s", flush=True)
    for tree in (state.g_params, state.d_params):
        check(all(bool(torch.isfinite(p).all()) for p in tree.values()), "non-finite weights")

    def one():
        nonlocal state
        state, _ = alternation(trainer, state, audio, text_it)

    profile_call(torch, one, "one gan+eodm alternation at full width")


def phase_unsup_wgan(torch, np) -> None:
    """The WGAN-GP objective at configs/timit_unsup_gan_eodm.yaml's model,
    gan and eodm sections (classifier 512 x 2, context 4, splice +-1;
    critic 256 x 3, kernel 5; lambda_gp 10; EODM orders 2 and 3, top-k
    1000; B = 32 at 8 s) on a formant corpus standing in for the TIMIT
    lists (V = 62), with the semi-supervised CTC mix-in
    (``gan.supervised_weight`` 0.5, ``ctc.use_pallas``: K3 and K3-bwd)
    through run_gan_training; every logged loss finite."""
    import tempfile

    from uasr_torch import train
    from uasr_torch.config import load_config

    dev = torch.device(DEVICE)
    cfg = load_config(os.path.join(REPO, "configs", "timit_unsup_gan_eodm.yaml"))
    steps = 3
    with tempfile.TemporaryDirectory() as tmp:
        cfg = cfg.replace(
            model_dir=tmp, vocab_size=UNSUP_WGAN_V,
            gan=dataclasses.replace(cfg.gan, supervised_weight=0.5),
            ctc=dataclasses.replace(cfg.ctc, use_pallas=True),
            data=dataclasses.replace(cfg.data, synthetic=True, synthetic_style="formant",
                                     synthetic_syntax="markov", synthetic_min_len=20,
                                     synthetic_max_len=45),
            train=dataclasses.replace(cfg.train, total_steps=steps, log_every=1))
        examples, vocab = unsup_corpus(cfg, UNSUP_UTTS, seed=5)
        check(len(vocab) == cfg.dim_output, f"vocabulary of {len(vocab)}")
        labeled = examples[: cfg.data.synthetic_labeled_utts]
        while len(labeled) < cfg.data.batch_size:
            labeled = labeled + labeled
        m, g = cfg.model, cfg.gan
        print(f"unsup wgan-gp: {cfg.name} classifier {m.classifier_hidden} x "
              f"{m.classifier_layers} context {m.classifier_context}, input "
              f"{cfg.frontend.dim_input}, critic {m.disc_channels} x {m.disc_layers} kernel "
              f"{m.disc_kernel}, lambda_gp {g.lambda_gp}, EODM {list(cfg.eodm.ngram_orders)} "
              f"top-k {cfg.eodm.top_k}, CTC mix-in {g.supervised_weight}, V={cfg.dim_output}, "
              f"B={cfg.data.batch_size} at {cfg.data.max_audio_seconds} s", flush=True)
        reset_launches()
        _, state = train.run_gan_training(
            cfg, unsup_batches(cfg, examples, cfg.train.seed), [ids for _, ids in examples],
            with_eodm=True, labeled_batches=unsup_batches(cfg, labeled, cfg.train.seed + 1),
            device=dev)
        counts = read_launches()
        with open(os.path.join(tmp, "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
    check(state.step == steps and len(recs) == steps, f"{len(recs)} logged steps")
    for r in recs:
        vals = {k: r[k] for k in ("d_loss", "gp", "wasserstein", "g_loss", "eodm_loss",
                                  "sup_ctc")}
        print(f"  step {r['step']}: " + ", ".join(f"{k} {v:.4f}" for k, v in vals.items())
              + f", {r['steps_per_sec']:.2f} steps/s", flush=True)
        check(all(math.isfinite(v) for v in vals.values()), f"step {r['step']}: {vals}")
    print(f"  launches over {steps} steps: {counts}", flush=True)
    want = dict.fromkeys(counts, 0)
    # each critic step's and each generator step's features, and the labeled batch's
    want.update(K1=steps * (g.disc_steps + 2), K3=steps, **{"K3-bwd": steps})
    check(counts == want, f"wgan-gp launches {counts}, expected {want}")


@contextlib.contextmanager
def deterministic(torch):
    """cuDNN's deterministic algorithms, and a warning for any other op
    that has none, around a run whose result must reproduce."""
    saved = (torch.backends.cudnn.deterministic, torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled())
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved[0]
        torch.use_deterministic_algorithms(saved[1], warn_only=saved[2])


def phase_unsup_demo(torch, np, model_dir: str) -> None:
    """The acceptance run: configs/synthetic_unsup_demo.yaml trained for its
    600 steps through the CLI, then ``--mode infer`` (greedy; it must beat
    DEMO_PER_BAR) and ``--mode infer`` with ``ctc.use_beam`` (K4). The GAN
    alternation is chaotic, so the run is made reproducible: deterministic
    cuDNN algorithms, and a short run of the recipe first (the process's
    first run at these shapes takes other rounding than every later one);
    the acceptance run is then trained twice and the two runs' final
    weights must be bit-equal."""
    import io
    import re

    from uasr_torch import cli
    from uasr_torch.checkpoint import CheckpointManager

    def run(out_dir, *extra):
        buf = io.StringIO()
        reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf), deterministic(torch):
            rc = cli.main(["-c", os.path.join(REPO, "configs", "synthetic_unsup_demo.yaml"),
                           "--set", f"model_dir={out_dir}", *extra])
        torch.cuda.synchronize()
        check(rc == 0, f"cli {extra}: exit {rc}")
        return buf.getvalue(), time.perf_counter() - t0, read_launches()

    run(model_dir + "_warm", "--mode", "train", "--set", "train.total_steps=20")
    out, wall, counts = run(model_dir, "--mode", "train")
    dev_lines = [ln for ln in out.splitlines() if ln.startswith("[dev]")]
    print(f"unsup demo: synthetic_unsup_demo trained through the CLI in {wall:.1f} s; "
          + "; ".join(dev_lines) + f"; launches {counts}", flush=True)
    check(counts["K1"] > 0, f"demo training launches {counts}")
    again = model_dir + "_again"
    _, wall2, _ = run(again, "--mode", "train")
    blobs = []
    for d in (model_dir, again):
        step = CheckpointManager(os.path.join(d, "ckpt")).latest_step()
        blobs.append(torch.load(os.path.join(d, "ckpt", f"{step}.pt"),
                                weights_only=True)["leaves"])
    differ = [k for k, v in blobs[0].items()
              if not (torch.equal(v, blobs[1][k]) if isinstance(v, torch.Tensor)
                      else v == blobs[1][k])]
    print(f"  second training run ({wall2:.1f} s): final state bit-equal in "
          f"{len(blobs[0]) - len(differ)} of {len(blobs[0])} leaves", flush=True)
    check(not differ and blobs[0].keys() == blobs[1].keys(),
          f"the demo run does not reproduce: {differ[:6]}")
    for mode, extra in (("greedy", ()), ("beam", ("--set", "ctc.use_beam=true"))):
        out, wall, counts = run(model_dir, "--mode", "infer", *extra)
        hit = re.search(r"PER=([0-9.]+)", out)
        check(hit is not None, f"infer printed {out!r}")
        per = float(hit.group(1))
        print(f"  --mode infer ({mode}): {out.strip()} in {wall:.1f} s; launches {counts}",
              flush=True)
        check(counts["K1"] > 0 and (counts["K4"] > 0) == (mode == "beam"),
              f"{mode} infer launches {counts}")
        if mode == "greedy":
            check(per < DEMO_PER_BAR, f"demo dev PER {per} not below {DEMO_PER_BAR}")


def phase_unsup_stream(torch, np, model_dir: str) -> None:
    """The demo checkpoint streamed through StreamingRecognizer with
    streaming CMVN (K7 once a step) and downsample 1, which streaming
    needs (it was trained on utterance CMVN at downsample 3; the check is
    between two paths on the same weights): the merged-stream collapse's
    tokens against the offline greedy decode of the merged stream
    (``GeneratorInfer.logits_fn``), for every stream."""
    from uasr_torch import cli
    from uasr_torch.config import load_config
    from uasr_torch.data.dataset import Batch
    from uasr_torch.ops.decode import ctc_greedy_decode
    from uasr_torch.serve import StreamingRecognizer

    dev = torch.device(DEVICE)
    cfg = load_config(os.path.join(REPO, "configs", "synthetic_unsup_demo.yaml"))
    cli.apply_overrides(cfg, [f"model_dir={model_dir}", "frontend.cmvn=streaming",
                              "frontend.downsample=1"])
    ginf, step = cli.restore_trainer(cfg, dev)
    rec = StreamingRecognizer(cfg, ginf.gen, device=dev)
    check(rec.collapse == "merge", f"collapse {rec.collapse}")
    examples, _ = unsup_corpus(cfg, STREAM_B, seed=2)
    lens = np.array([len(a) for a, _ in examples], np.int32)
    L = -(-int(lens.max()) // rec.chunk_samples) * rec.chunk_samples
    audio = np.zeros((STREAM_B, L), np.float32)
    for i, (a, _) in enumerate(examples):
        audio[i, : len(a)] = a
    batch = Batch(audio, lens, np.zeros((STREAM_B, 1), np.int32), np.zeros(STREAM_B, np.int32))
    want = dict.fromkeys(read_launches(), 0)
    want["K7"] = 1

    def per_step(d):
        check(d == want, f"merged-stream step launches {d}, expected {want}")

    part, tail, lat, _ = stream_batch(torch, np, rec, batch, per_step)
    streamed = [p + t for p, t in zip(part, tail)]
    with torch.inference_mode():
        logits, n = ginf.logits_fn(torch.as_tensor(audio, device=dev),
                                   torch.as_tensor(lens, device=dev, dtype=torch.long))
        ids, k = ctc_greedy_decode(logits, n, cfg.ctc.blank_id)
    ids, k = ids.cpu().numpy(), k.cpu().numpy()
    offline = [ids[b, : k[b]].tolist() for b in range(STREAM_B)]
    bad = [b for b in range(STREAM_B) if streamed[b] != offline[b]]
    print(f"unsup stream: step {step} checkpoint, {STREAM_B} streams, chunk {rec.chunk} frames, "
          f"merged-stream greedy == offline merged greedy for {STREAM_B - len(bad)} of "
          f"{STREAM_B} streams, {np.mean([len(o) for o in offline]):.1f} tokens per stream",
          flush=True)
    check(not bad, f"merged streams {bad[:8]} differ from the offline decode")
    check(sum(map(len, offline)) > 0, "the merged stream emitted nothing")
    report_latency(np, f"B={STREAM_B}", lat[1:], STREAM_B,
                   rec.chunk_samples / cfg.frontend.sample_rate)


def phase_unsup(torch, np) -> None:
    import tempfile

    phase_unsup_full(torch, np)
    phase_unsup_wgan(torch, np)
    with tempfile.TemporaryDirectory() as tmp:
        demo = os.path.join(tmp, "demo")
        phase_unsup_demo(torch, np, demo)
        phase_unsup_stream(torch, np, demo)


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
    phase_stream_kernels(torch, np, results)
    launches: dict = {}
    phase_slice(torch, np, launches)
    phase_train(torch, np, launches)
    phase_stream(torch, np, launches)
    phase_daemon(torch, np)
    phase_k5_k6(torch, np, results)
    phase_recurrent_stream(torch, np, launches)
    phase_daemon(torch, np, "lc_bigru", rounds=2)
    phase_attention(torch, np, launches)
    phase_train_k5_k6(torch, np, results)
    phase_encoder_train(torch, np, launches)
    phase_unsup(torch, np)

    rows = [
        ("K1 fused log-mel", "uasr_torch/csrc/log_mel.cu",
         "uasr/frontend/pallas_frontend.py:125", "K1", "K1:highest"),
        ("K2 BiGRU forward (K5's kernel gru_fwd_kernel.cuh with two groups)",
         "uasr_torch/csrc/bigru_fwd.cu",
         "uasr/models/pallas_gru.py:537", "K2", "K2:bfloat16"),
        ("K4 CTC prefix beam", "uasr_torch/csrc/ctc_beam.cu",
         "uasr/ops/pallas_beam.py:70", "K4", "K4:none"),
        ("K2-bwd BiGRU backward (coefficient kernel gru_bwd_coeffs.cuh, then the reverse "
         "chain gru_bwd_chain.cuh)", "uasr_torch/csrc/bigru_bwd.cu",
         "uasr/models/pallas_gru.py:567", "K2-bwd", "K2-bwd:bfloat16"),
        ("K3 CTC alpha", "uasr_torch/csrc/ctc_alpha.cu",
         "uasr/ops/pallas_ctc.py:64", "K3", "K3"),
        ("K3-bwd CTC beta / d(emit)", "uasr_torch/csrc/ctc_beta.cu",
         "uasr/ops/pallas_ctc.py:89", "K3-bwd", "K3-bwd"),
        ("K7 unfused log-mel (streaming chunk)", "uasr_torch/csrc/log_mel.cu",
         "uasr/frontend/pallas_frontend.py:73", "K7", "K7:highest"),
        (f"K4 CTC prefix beam (streaming chunk, V={STREAM_V}, W={STREAM_W})",
         "uasr_torch/csrc/ctc_beam.cu", "uasr/ops/pallas_beam.py:70", "K4:stream",
         f"K4:V{STREAM_V}:chunk"),
        ("K5 grouped GRU forward (lc_bigru streaming step windows)", "uasr_torch/csrc/gru_fwd.cu",
         "uasr/models/pallas_gru.py:75", "K5", "K5:step"),
        ("K6 fused MHSA forward (conformer, relative-position bias)",
         "uasr_torch/csrc/mhsa_fwd.cu", "uasr/ops/pallas_attention.py:75", "K6", "K6:bias"),
        ("K5-bwd grouped GRU backward, fused (12 s forward GRU, f32)",
         "uasr_torch/csrc/gru_bwd.cu", "uasr/models/pallas_gru.py:172", "K5-bwd",
         "K5-bwd:offline:float32"),
        ("K8 grouped GRU backward, linear (12 s forward GRU, f32)",
         "uasr_torch/csrc/gru_bwd_lin.cu", "uasr/models/pallas_gru.py:133", "K8",
         "K8:offline:float32"),
        ("K6-bwd fused MHSA backward (conformer, relative-position bias)",
         "uasr_torch/csrc/mhsa_bwd.cu", "uasr/ops/pallas_attention.py:112", "K6-bwd",
         "K6-bwd:bias"),
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
