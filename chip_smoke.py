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
   then self-training from the demo's generator through
   ``uasr_torch.tools.selftrain`` and ``tools.sweep`` (phase_selftrain): two
   rounds of frame-CE students on forced-aligned pseudo-labels from the
   teacher's weights, a CTC student on Viterbi-refined labels (a ``prepare
   lm`` bigram of the train split's transcripts), a two-seed sweep with
   label-free selection and a round from the winner's best_ckpt, each
   with its PERs, kept fraction, confidence, rates, frame_acc and wall;
   phase 2 also prints K1's and K7's distance from the same formula in f64;
13. training and decode straight from utterance lists on disk: a seeded
   corpus of 256 PCM16 wavs (64 each in the 4, 8, 12 and 16 s buckets,
   ~82 MB) and a 64-utterance test list written to a temporary directory
   with ``prepare lists`` (lists and ``.lens`` sidecars); the streaming
   loader's audio-s/s over the corpus at ``loader_threads`` 0 (one thread
   per core) and 8; ``uasr_torch.cli.main`` in process, with
   ``data.streaming`` at its default: configs/librispeech_ctc_bigru.yaml
   at full width for 8 steps (each step's wall, its wait on the
   prefetched stream and its launches: 1 K1, 3 K2, 3 K2-bwd chains and 3
   of their coefficient kernels, 1 K3, 1 K3-bwd), the process's RSS
   growth, then ``--mode infer`` with beam 16 over the test list (1 K1, 3
   K2 and 1 K4 per request) and the native edit distance against the
   torch one on the card on each request's hypotheses;
   configs/timit_ctc_mini.yaml from a 64-utterance list of TIMIT's 61
   phone names, 4 steps, then ``--mode infer`` with its finite
   ``PER_folded``;
14. LM and HMM decode: configs/librispeech_ctc_bigru.yaml's four requests
   decoded by ``run_inference`` with ``ctc.lm_path``, once with a bigram
   [33, 32] from ``prepare lm`` and once with a trigram [33, 33, 32] from
   ``prepare import-arpa`` of an ARPA file written here (1 K1, 3 K2, 1 K4
   a request; K4 on each request's log-probs bit-equal to its plain
   version, timed with its bound); configs/aishell_streaming.yaml's 64
   streams through StreamingRecognizer with a [4234, 4233] bigram (1 K7
   and 1 K4 a step, finals equal to the offline LM beam; K4 on two steps'
   inputs bit-equal, timed) and the daemon for two rounds with it;
   configs/formant39_unsup.yaml's generator decoded with
   ``ctc.use_viterbi`` over a bigram and a trigram from ``prepare lm``
   (rates calibrated on four probe batches, 1 K1 a batch and probe, card
   ids equal to the CPU's on the same logits); phase 13's timit_ctc_mini
   checkpoint through ``--mode infer --set ctc.use_viterbi=true``; and
   ``uasr_torch.tools.align`` on phase 13's librispeech_ctc_bigru
   checkpoint (1 K1 and 3 K2 a batch), every alignment that fits its
   frames collapsing to its transcript;
15. frame-CE training (phase_frame_ce): ``tools.align`` over phase 13's
   256-wav train list, ``--set train.mode=frame_ce`` through the CLI on the
   aligned list at librispeech_ctc_bigru's full width for 8 steps (1 K1, 3
   K2, 3 K2-bwd each, with its wall and frame_acc), the frame-CE and the
   CTC step on one batch in turns with a profile of each, the first
   batch's kernel path against
   the plain path, ``--mode infer`` of the frame-CE checkpoint and
   ``tools.align`` on it, every fitting alignment collapsing;
16. SSL pretraining and the feature-cache path (phase_ssl): K5 and K5-bwd
   at the context GRU's shape (G = 1, T = 600, B = 16, H = 512, f32)
   against their plain versions; configs/formant39_ssl.yaml at full width
   through the CLI on a 360-utterance formant corpus from ``prepare
   synth`` with ``ssl.context_pallas=true``: 20 steps (1 K5, 1 K5-bwd and
   its coefficient kernel each; the median wall of the last 10, nce_acc,
   a profile), 4 with ``ssl.input_type=fbank`` (1 K1 more) and 4 with
   ``ssl.fused_loss=true``, each first step on the kernel path against the
   plain path; ``tools.featurize --cmvn --pca 512 --pool-kmeans 128`` of
   the train split and, through its transforms, the dev split; ``prepare
   kmeans --feature-cache``; configs/wav2vecu_pod_stretch.yaml's gan+eodm
   over the cache from the device-resident corpus at its widths (B = 256,
   bf16; 8 alternations, the corpus's bytes and upload, each batch's issue
   and one gather on the card), ``--mode infer`` from the dev cache and
   one self-training round over the cached features;
17. the one-command unsupervised pipeline (phase_pipeline):
   ``tools.pipeline`` over phase 16's formant corpus with its ssl stage
   resuming phase 16's checkpoint, featurize ``--cmvn --pca 512``, the
   bigram LM, two seeds of wav2vecu_pod_stretch's gan+eodm over the cache
   and one self-training round, with each stage's seconds and the
   teacher's and student's dev PER;
18. the serving export (phase_export): ``tools.export`` with ``--check``
   of phase 13's librispeech_ctc_bigru checkpoint (beam 16, B = 32 x 16 s),
   of phase 17's winner through ``--compose-from-pipeline``, of
   aishell_streaming's cnn ``--streaming`` in f32 and with ``--quantize
   int8-compute`` and of a seeded conformer; each ``torch.export`` program
   reloaded and bit-equal to the live forward on the card, its launches
   a call (K1, K2, K4; K5; K7, K4; K1, K6, K4), size and call time; the
   librispeech program also run in a fresh process that imports only
   torch and ``uasr_torch.ops.library``;
19. distribution (phase_distributed): librispeech_ctc_bigru at full width
   (B = 32 x 8 s, SpecAugment off) with ``train.grad_accum: 2`` over two
   halves on a one-rank NCCL group against one step (twice the K2 and
   K2-bwd launches, the first Adam moments at the first-step bars); two
   ranks on cuda:0 over gloo (NCCL refuses two ranks a device), each
   ``chip_smoke.py --dist-rank``: the data-parallel step on mesh (2, 1),
   the transformer (d = 512, 8 x 64, 4 blocks) with ``sequence_shard`` on
   mesh (1, 2), K6 and K6-bwd on each rank's 4 heads, and the beam-16
   decode split over mesh (2, 1), ids bit-equal to one process, against
   one process, with each step's collective time; the multichip dry run on
   four ranks (mesh (2, 2));
20. one JSON line listing every ported kernel with its check, times and
   bound, then the card line and the result line.

It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
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
        res, ref = check_beam(torch, k4, args, f"K4 {name}")
        ms = cuda_ms(torch, lambda: k4.ctc_beam_cuda(*args), 10)
        plain = cuda_ms(torch, lambda: k4.ctc_beam_reference(*args), 1, warmup=0)
        rows = 0 if tab is None else lm_rows(torch, ref, None, lengths, V, order)
        bms, by = beam_bound(lengths, T, B, W, V, rows * V, order)
        print(f"K4 beam    {name:8s} T={T} B={B} W={W} V={V}: backpointers, state and ids "
              f"equal, score max|d| {res['max_abs_err']:.3e} kernel {ms:.4f} ms "
              f"({beam_plan(k4, ms, lengths)}) plain {plain:.4f} ms bound {bms:.6f} ms ({by})",
              flush=True)
        results[f"K4:{name}"] = dict(res, ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
                                     library_ms=None)


def check_beam(torch, k4, args, what: str, state=None) -> tuple:
    """K4 against its plain version on the same inputs (and start state):
    backpointers and the state out bit-equal, tracebacks equal, best
    scores to 1e-4. Returns ({max_abs_err}, the plain version's output)."""
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
    return dict(max_abs_err=err), ref


def lm_rows(torch, out, state, lengths, V: int, order: int) -> int:
    """The distinct LM table rows a K4 call needs: the histories (last
    symbol; for a trigram also the one before) of every beam at every
    step its row is active, replayed from the call's backpointers
    ``out`` = (parents, chars, _) from its start ``state`` (None: fresh).
    A dead beam's history is counted too; dead beams occur only at a
    fresh start, where they share the live beam's start row."""
    parents, chars = out[0].long(), out[1].long()
    T, B, W = parents.shape
    if state is None:
        last = last2 = torch.full((B, W), -1, dtype=torch.long, device=parents.device)
    else:
        last, last2 = state.last.long(), state.last2.long()
    lengths = lengths.to(parents.device)
    seen = []
    for t in range(T):
        hist = torch.where(last >= 0, last, V)
        if order == 3:
            hist = hist + torch.where(last2 >= 0, last2, V) * (V + 1)
        seen.append(hist[t < lengths])
        is_ext = chars[t] >= 0
        p_last, p_last2 = last.gather(1, parents[t]), last2.gather(1, parents[t])
        last, last2 = torch.where(is_ext, chars[t], p_last), torch.where(is_ext, p_last, p_last2)
    return int(torch.unique(torch.cat(seen)).numel())


def beam_plan(k4, ms: float, lengths) -> str:
    """K4's launch plan and its µs per step of the longest utterance."""
    warps, ctas = k4.LAST_BEAM_PLAN
    return (f"{warps} warps x {ctas} CTA(s) per utterance, "
            f"{ms * 1e3 / max(int(lengths.max()), 1):.3f} us/step")


def beam_bound(lengths, T: int, B: int, W: int, V: int, lm_size: int, order: int):
    """K4's least time: the work of the steps this run's lengths keep
    active (the W*V extends with their LM terms, the fold, one top-W
    selection pass of ~2 comparisons per candidate over the W*V + W
    candidates, the rebuild), and the bytes of log-probs, lengths, the
    ``lm_size`` LM entries the call reads (the rows of ``lm_rows``),
    backpointers and state."""
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


def phase_adam_kernels(torch, np, results: dict) -> None:
    """K-norm and K-adam at the librispeech BiGRU's 22 f32 leaves
    (15,031,264 parameters; ``tools.time_adam``'s problem) against their
    plain versions: below the clip (global norm 2.5 of 5) the parameters
    and both moments bit for bit; above it (norm 20) the norm within rtol
    1e-6 and K-adam from the plain norm bit for bit. Times of the pair, the
    plain per-leaf version, ``torch._fused_adam_`` after a foreach clip
    (library) and the foreach form in optax's order; the bound is 32 bytes
    an f32 element (K-adam's 28, K-norm's 4)."""
    from uasr_torch.ops import cuda_adam as ka
    from uasr_torch.tools import time_adam as ta

    dev = torch.device(DEVICE)
    n = sum(ta.SIZES)
    flags = [False] * len(ta.SIZES)
    errs = []
    for norm in (2.5, 20.0):
        start = ta.problem(torch, dev, norm, seed=SEED + 5)

        def state():
            p, g, m, v = start
            return [[x.clone() for x in p], g, [x.clone() for x in m], [x.clone() for x in v]]

        ref, got, alone = state(), state(), state()
        ref_norm = ka.sq_norms_reference(ref[1])[2]
        ka.clip_adam_reference(*ref, ref_norm, **ta.ADAM, **ta.scalars())
        before = ka.LAUNCHES
        got_norm = ka.sq_norms_cuda(got[1], flags)[2]
        ka.clip_adam_cuda(*got, got_norm, **ta.ADAM, **ta.scalars())
        ka.clip_adam_cuda(*alone, ref_norm, **ta.ADAM, **ta.scalars())
        torch.cuda.synchronize()
        check(ka.LAUNCHES - before == 3, f"K-norm + K-adam: {ka.LAUNCHES - before} launches")
        rel = _rel(float(got_norm), float(ref_norm))
        check(rel <= 1e-6, f"K-norm at norm {norm}: {float(got_norm)} vs {float(ref_norm)}")
        trees = [alone, got] if norm < ta.ADAM["max_norm"] else [alone]
        for fused in trees:
            for name, a, b in zip(("parameters", "mu", "nu"), (fused[0], fused[2], fused[3]),
                                  (ref[0], ref[2], ref[3])):
                check(all(torch.equal(x, y) for x, y in zip(a, b)),
                      f"K-adam at norm {norm}: {name} differ from the plain version's")
        err = max(float((x - y).abs().max()) for x, y in zip(got[0], ref[0]))
        errs.append(err)
        print(f"K-norm + K-adam, 22 BiGRU leaves, global norm {norm} (clip "
              f"{ta.ADAM['max_norm']}): norm {float(got_norm):.7f} vs plain "
              f"{float(ref_norm):.7f} (rel {rel:.2e}); parameters and moments bit-equal to the "
              f"plain version's{'' if len(trees) == 2 else ' from the plain norm'}; own-norm "
              f"update max|dp| {err:.3e}", flush=True)
    ms = cuda_ms(torch, lambda: ta.fused(*start), 20)
    plain = cuda_ms(torch, lambda: ta.plain(*start), 5)
    foreach = cuda_ms(torch, lambda: ta.foreach(*start), 20)
    steps = [torch.full((), float(ta.COUNT - 1), device=dev) for _ in ta.SIZES]
    lib = cuda_ms(torch, lambda: ta.fused_library(*start, steps), 20)
    bms, by = bound(32 * n, 16 * n, "float32")
    print(f"  K-norm + K-adam {ms:.4f} ms, plain per-leaf {plain:.4f} ms, foreach in optax's "
          f"order {foreach:.4f} ms, foreach clip + torch._fused_adam_ {lib:.4f} ms, bound "
          f"{bms:.4f} ms ({by})", flush=True)
    results["K-adam:bigru22"] = dict(max_abs_err=max(errs), ms=ms, plain_ms=plain, bound_ms=bms,
                                     bound_by=by, library_ms=lib)


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
        res, _ = check_beam(torch, k4, args, f"K4 V={V} {what}", state=state)
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
    from uasr_torch.ops import cuda_adam as ka
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
             (k4, "ctc_beam_cuda", k4.ctc_beam_reference),
             (ka, "sq_norms_cuda", ka.sq_norms_reference),
             (ka, "clip_adam_cuda", ka.clip_adam_reference)]
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
    from uasr_torch.ops import cuda_adam, cuda_attention, cuda_beam, cuda_ctc

    # "K-adam" counts K-norm's and K-adam's launches: 2 an optimizer update of
    # up to 64 leaves (adam_launches)
    return {"K1": (cuda_frontend, "LAUNCHES"), "K7": (cuda_frontend, "LAUNCHES_UNFUSED"),
            "K2": (cuda_gru, "LAUNCHES"),
            "K2-bwd": (cuda_gru, "LAUNCHES_BWD"),
            "K2-bwd:coeffs": (cuda_gru, "LAUNCHES_BWD_COEFFS"), "K3": (cuda_ctc, "LAUNCHES"),
            "K3-bwd": (cuda_ctc, "LAUNCHES_BWD"), "K4": (cuda_beam, "LAUNCHES"),
            "K5": (cuda_gru, "LAUNCHES_GRU"), "K6": (cuda_attention, "LAUNCHES_ATTN"),
            "K5-bwd": (cuda_gru, "LAUNCHES_GRU_BWD"),
            "K5-bwd:coeffs": (cuda_gru, "LAUNCHES_GRU_COEFFS"), "K8": (cuda_gru, "LAUNCHES_GRU_LIN"),
            "K6-bwd": (cuda_attention, "LAUNCHES_ATTN_BWD"), "K-adam": (cuda_adam, "LAUNCHES")}


def adam_launches(params: dict) -> int:
    """K-norm's and K-adam's launches in one update of ``params``: two a
    table of up to ``cuda_adam.TABLE_LEAVES`` leaves."""
    from uasr_torch.ops import cuda_adam

    return 2 * len(cuda_adam.plan_tables([p.numel() for p in params.values()]))


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
            "K4": 0, "K5": 0, "K6": 0, "K5-bwd": 0, "K5-bwd:coeffs": 0, "K8": 0, "K6-bwd": 0,
            "K-adam": 2}
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
    launches.update({k: total[k] for k in ("K2-bwd", "K3", "K3-bwd", "K-adam")})
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
    from uasr_torch.ops import cuda_adam

    dev = torch.device(DEVICE)
    for dtype, (tl, tn, tw) in (("bfloat16", (1e-3, 1e-2, 5e-2)), ("float32", (1e-5, 1e-4, 1e-3))):
        t = train.CTCTrainer(dataclasses.replace(cfg, model=dataclasses.replace(cfg.model,
                                                                                dtype=dtype)),
                             device=dev)
        aux_k, g_k = t.loss_and_grads(params, db, t.step_generator(0))
        with plain_versions():
            aux_p, g_p = t.loss_and_grads(params, db, t.step_generator(0))
        lk, lp = float(aux_k["loss"]), float(aux_p["loss"])
        nk = float(cuda_adam.sq_norms_reference(g_k.values())[2])
        npl = float(cuda_adam.sq_norms_reference(g_p.values())[2])
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
                   "K8": 0, "K6-bwd": 0, "K-adam": 0}

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


def phase_daemon(torch, np, encoder: str = "cnn", rounds: int = 4,
                 lm_path: str | None = None) -> None:
    """The TCP serving daemon on localhost with 8 slots. Staggered: 8
    clients stream their utterances while a ninth is refused as busy.
    Sustained: 8 clients stream rounds - 1 utterances each, one connection
    per utterance, back to back, with the engine's tick statistics. Every
    final transcript equals the offline beam decode (with ``lm_path``, the
    beam fuses that table in both). Every socket and wait has a timeout."""
    import threading

    from uasr_torch.frontend.features import make_frontend_state
    from uasr_torch.models.models import build_model
    from uasr_torch.tools.serve_daemon import StreamClient, TickStats, create_server

    dev = torch.device(DEVICE)
    cfg = aishell_config(encoder)
    if lm_path:
        cfg = cfg.replace(ctc=dataclasses.replace(cfg.ctc, lm_path=lm_path,
                                                  lm_bonus=STREAM_LM_BONUS))
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
    tag = encoder + (", bigram LM" if lm_path else "")
    print(f"daemon ({tag}): {DAEMON_SLOTS} slots; {DAEMON_SLOTS} staggered clients with a ninth refused "
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
            padded audio, the utterance-CMVN one K1; K-norm and K-adam
            once a table of leaves."""
            adam = adam_launches(state.params)
            if recurrent:
                grus = (2 if encoder == "lc_bigru" else 1) * m.num_gru_layers
                chunk = cfg.frontend.streaming_chunk_frames * cfg.frontend.frame_shift
                fused = {"K5-bwd": grus, "K5-bwd:coeffs": grus}  # a chain and its coefficients
                return dict(zero, K7=-(-b.audio.shape[1] // chunk), K5=grus, K3=1, **{
                    "K3-bwd": 1, "K-adam": adam, **({"K8": grus} if linear else fused)})
            return dict(zero, K1=1, K6=m.transformer_layers, K3=1,
                        **{"K6-bwd": m.transformer_layers, "K3-bwd": 1, "K-adam": adam})

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
    want["K-adam"] = 2 * UNSUP_STEPS * (g.disc_steps + 1)  # an update a critic or generator step
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
    want.update(K1=steps * (g.disc_steps + 2), K3=steps,
                **{"K3-bwd": steps, "K-adam": 2 * steps * (g.disc_steps + 1)})
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


# the self-training phase: student steps per round, and the sweep's steps
SELF_STEPS, SWEEP_STEPS = 100, 20


def phase_selftrain(torch, np, demo: str, launches: dict) -> None:
    """Self-training from the unsupervised demo's generator (phase 12's
    checkpoint under ``demo``, dev PER below DEMO_PER_BAR) as the teacher,
    through ``tools.selftrain`` and ``tools.sweep`` on
    configs/synthetic_unsup_demo.yaml: (a) two rounds of frame-CE students
    on forced-aligned pseudo-labels, round 0 from the teacher's weights;
    (b) one round of a CTC student on HMM-refined labels (Viterbi over a
    ``prepare lm`` bigram of the train split's transcripts, its rates
    calibrated on the teacher); (c) a two-seed sweep with label-free
    selection, then one round from the winner's ``best_ckpt``. Each run's
    teacher and student PER, kept fraction, mean confidence, rates,
    frame_acc at the first and last logged step, wall and launches; the
    gates: finite PERs, frame_acc logged by every aligned round, a
    checkpoint in every ``selftrain_r*``."""
    import re

    from uasr_torch import cli
    from uasr_torch.config import load_config
    from uasr_torch.tools import prepare, selftrain, sweep

    t_phase = time.perf_counter()
    recipe = os.path.join(REPO, "configs", "synthetic_unsup_demo.yaml")
    root = os.path.dirname(demo)
    (_, examples), vocab = cli._load_source(load_config(recipe), "train")
    with open(os.path.join(root, "vocab.txt"), "w") as f:
        f.write("\n".join(vocab.tokens) + "\n")
    write_text(os.path.join(root, "train_text.txt"),
               [[vocab.tokens[i] for i in ids] for _, ids in examples])
    lm = os.path.join(root, "train_lm2.npz")
    prepare_quiet(prepare, ["lm", "--text", os.path.join(root, "train_text.txt"), "--vocab",
                            os.path.join(root, "vocab.txt"), "--out", lm])

    def run(main, argv):
        out, err = io.StringIO(), io.StringIO()
        reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = main(["-c", recipe, *argv])
        torch.cuda.synchronize()
        check(rc == 0, f"{argv[:6]}: exit {rc}")
        counts = read_launches()
        launches["K1"] += counts["K1"]
        return out.getvalue(), err.getvalue(), time.perf_counter() - t0, counts

    def student(what, argv, rounds, aligned):
        model_dir = os.path.join(root, what)
        out, err, wall, counts = run(selftrain.main, [*argv, "--rounds", str(rounds), "--set",
                                                      f"model_dir={model_dir}", "--set",
                                                      f"train.log_every={max(SELF_STEPS // 10, 1)}"])
        hit = re.search(r"teacher PER=(\S+) student PER=(\S+)", out)
        check(hit is not None, f"{what}: printed {out!r}")
        pers = float(hit.group(1)), float(hit.group(2))
        check(all(np.isfinite(pers)), f"{what}: PERs {pers}")
        check(counts["K1"] > 0, f"{what}: launches {counts}")
        kept = re.findall(r"round (\d+): kept (\d+)/(\d+) \(mean conf ([0-9.]+)\)", out)
        check(len(kept) == rounds, f"{what}: {out!r}")
        rates = re.search(r"Viterbi rates (.*)", err)
        parts = []
        for r, a, n, conf in kept:
            rdir = os.path.join(model_dir, f"selftrain_r{r}")
            check(any(fn.endswith(".pt") for fn in os.listdir(os.path.join(rdir, "ckpt"))),
                  f"{rdir}: no checkpoint")
            with open(os.path.join(rdir, "metrics.jsonl")) as f:
                accs = [json.loads(ln).get("frame_acc") for ln in f if '"train"' in ln]
            accs = [x for x in accs if x is not None]
            check(bool(accs) == aligned, f"{rdir}: frame_acc logged {accs}")
            parts.append(f"round {r} kept {int(a) / int(n):.4f} of {n}, mean conf {conf}"
                         + (f", frame_acc {accs[0]:.4f} -> {accs[-1]:.4f}" if accs else ""))
        print(f"  {what}: teacher PER {pers[0]:.4f}, student PER {pers[1]:.4f}; "
              + "; ".join(parts) + (f"; rates {rates.group(1)}" if rates else "")
              + f"; wall {wall:.2f} s; launches { {k: v for k, v in counts.items() if v} }",
              flush=True)

    print(f"selftrain: teacher {demo} (the demo's generator), {len(examples)} train "
          f"utterances, bigram {tuple(np.load(lm)['logp'].shape)}", flush=True)
    steps = ["--student-steps", str(SELF_STEPS)]
    student("aligned", ["--teacher-dir", demo, "--teacher-mode", "gan", "--align-pseudo-labels",
                        "--init-from-teacher", *steps], 2, True)
    student("viterbi", ["--teacher-dir", demo, "--teacher-mode", "gan", *steps, "--set",
                        "ctc.use_viterbi=true", "--set", f"ctc.lm_path={lm}"], 1, False)
    out, _, wall, counts = run(sweep.main, ["--seeds", "2", "--set",
                                            f"model_dir={root}/sweep", "--set",
                                            f"train.total_steps={SWEEP_STEPS}", "--set",
                                            "train.eval_every=10", "--set",
                                            f"gan.select_lm_path={lm}"])
    with open(os.path.join(root, "sweep", "sweep.json")) as f:
        rec = json.load(f)
    check(json.loads(out.strip().splitlines()[-1]) == rec["winner"], f"sweep printed {out!r}")
    print(f"  sweep: 2 seeds x {SWEEP_STEPS} steps in {wall:.2f} s, scores "
          + ", ".join(f"seed {r['seed']} {r['score']:.4f}" for r in rec["ranking"])
          + f"; winner seed {rec['winner']['seed']}; launches "
          f"{ {k: v for k, v in counts.items() if v} }", flush=True)
    student("restore_best", ["--teacher-dir", rec["winner"]["model_dir"], "--teacher-mode",
                             "gan", "--restore-best", "--student-steps", str(SWEEP_STEPS)],
            1, False)
    print(f"  self-training phase: {time.perf_counter() - t_phase:.1f} s", flush=True)


def phase_unsup(torch, np, launches: dict) -> None:
    import tempfile

    phase_unsup_full(torch, np)
    phase_unsup_wgan(torch, np)
    with tempfile.TemporaryDirectory() as tmp:
        demo = os.path.join(tmp, "demo")
        phase_unsup_demo(torch, np, demo)
        phase_unsup_stream(torch, np, demo)
        phase_selftrain(torch, np, demo, launches)


# the data phase: DATA_PER_BUCKET utterances of random audio in each of the
# recipe's buckets (lengths in (hi - 0.25, hi] s), DATA_TEST_UTTS more as the
# test list, DATA_STEPS training steps; the TIMIT run's list and steps
DATA_PER_BUCKET, DATA_TEST_UTTS, DATA_STEPS = 64, 64, 8
TIMIT_UTTS, TIMIT_STEPS = 64, 4
# TIMIT's 61 phones: the 23 that fold (uasr_torch.vocab.TIMIT_61_TO_39's
# keys) and these 38 that fold to themselves
TIMIT_SELF = ("aa ae ah aw ay b ch d dh dx eh er ey f g hh ih iy jh k l m n ng ow oy p r "
              "s sh t th uh uw v w y z").split()


def rss_bytes() -> int:
    with open("/proc/self/status") as f:
        for ln in f:
            if ln.startswith("VmRSS:"):
                return int(ln.split()[1]) * 1024
    raise RuntimeError("no VmRSS in /proc/self/status")


def write_list(np, root: str, name: str, utts, prepare) -> str:
    """``utts``: (audio, tokens) pairs. Writes the wavs, wav.scp and text,
    then ``prepare lists`` (the list and its .lens sidecar); returns the
    list's path."""
    from uasr_torch.data.io import write_wav

    scp, text = [], []
    for i, (audio, toks) in enumerate(utts):
        utt = f"{name}{i:04d}"
        path = os.path.join(root, "wav", f"{utt}.wav")
        write_wav(path, audio, 16000)
        scp.append(f"{utt} {path}\n")
        text.append(f"{utt} {' '.join(toks)}\n")
    for fname, lines in ((f"{name}.scp", scp), (f"{name}.text", text)):
        with open(os.path.join(root, fname), "w") as f:
            f.writelines(lines)
    out = os.path.join(root, f"{name}.tsv")
    with contextlib.redirect_stdout(io.StringIO()):
        rc = prepare.main(["lists", "--wav-scp", os.path.join(root, f"{name}.scp"), "--text",
                           os.path.join(root, f"{name}.text"), "--out", out])
    check(rc == 0 and os.path.exists(out + ".lens"), f"prepare lists {name}")
    return out


def random_utts(np, seed: int, seconds, n_per_bucket: int, vocab, cps: float = 14):
    """n_per_bucket utterances of 0.1-sigma noise per bucket, lengths in
    (hi - 0.25, hi] s, ``cps`` random characters per second."""
    rng = np.random.RandomState(seed)
    chars = vocab.tokens[1:29]  # the letters, the apostrophe and <space>
    utts = []
    for hi in seconds:
        for _ in range(n_per_bucket):
            n = int(rng.uniform(hi - 0.25, hi) * 16000)
            toks = [chars[j] for j in rng.randint(0, len(chars), int(n / 16000 * cps))]
            utts.append(((0.1 * rng.randn(n)).astype(np.float32), toks))
    return utts


def run_cli(torch, argv: list) -> str:
    """``uasr_torch.cli.main`` in process; its standard output."""
    from uasr_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    check(rc == 0, f"cli {argv[:4]}: exit {rc}")
    return buf.getvalue()


@contextlib.contextmanager
def traced_data_path(torch, record: dict):
    """Wrap the training step, the CLI's batch stream and the decode of a
    request so that each step's wall (ending in a synchronise), its
    launches and the RSS after it, the time each ``next()`` of the
    prefetched stream waited, and each request's wall, launches,
    references and hypotheses are recorded."""
    from uasr_torch import cli, infer, train

    orig_step, orig_batches, orig_decode = (train.CTCTrainer.train_step, cli._batches,
                                            infer._decode_batch)

    def step(self, state, batch):
        before = read_launches()
        t0 = time.perf_counter()
        out = orig_step(self, state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        after = read_launches()
        record["steps"].append(dict(wall=wall, shape=tuple(batch[0].shape),
                                    launches={k: after[k] - before[k] for k in after},
                                    rss=rss_bytes()))
        return out

    def batches(*a, **k):
        it = orig_batches(*a, **k)
        try:
            while True:
                t0 = time.perf_counter()
                try:
                    b = next(it)
                except StopIteration:
                    return
                record["waits"].append(time.perf_counter() - t0)
                yield b
        finally:
            it.close()

    def decode(cfg, model, fstate, db, *rest):
        torch.cuda.synchronize()
        before = read_launches()
        t0 = time.perf_counter()
        out = orig_decode(cfg, model, fstate, db, *rest)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        after = read_launches()
        record["requests"].append(dict(launches={k: after[k] - before[k] for k in after},
                                       wall=wall, refs=db[2].clone(), ref_len=db[3].clone(),
                                       hyps=out[0].clone(), hyp_len=out[1].clone()))
        return out

    train.CTCTrainer.train_step, cli._batches, infer._decode_batch = step, batches, decode
    try:
        yield
    finally:
        train.CTCTrainer.train_step, cli._batches, infer._decode_batch = (
            orig_step, orig_batches, orig_decode)


def loader_rate(np, lst: str, vocab, cfg, threads: int) -> tuple[float, float]:
    """(audio-s/s, seconds) of one epoch of ``StreamingASRDataset.batches``
    over ``lst`` with ``threads`` decode threads, no training."""
    from uasr_torch.data.loader import StreamingASRDataset

    sr = cfg.frontend.sample_rate
    ds = StreamingASRDataset.from_file(lst, vocab, sr)
    t0 = time.perf_counter()
    secs = 0.0
    for b in ds.batches(batch_size=cfg.data.batch_size,
                        max_audio_samples=int(cfg.data.max_audio_seconds * sr),
                        max_label_len=cfg.data.max_label_len, num_epochs=1,
                        drop_remainder=False, decode_threads=threads,
                        bucket_boundaries=[int(s * sr) for s in cfg.data.bucket_boundaries]):
        secs += float(np.sum(b.audio_lengths)) / sr
    wall = time.perf_counter() - t0
    return secs / wall, wall


def phase_data(torch, np, root: str) -> None:
    """Training and decode from utterance lists on disk through the CLI,
    the streaming loader's rate, and a TIMIT-style list's folded PER."""
    import re

    from uasr_torch.native import batch_edit_distance_native
    from uasr_torch.ops.edit_distance import batch_edit_distance
    from uasr_torch.tools import prepare
    from uasr_torch.vocab import TIMIT_61_TO_39

    t_phase = time.perf_counter()
    vocab = char_vocab()
    cfg = recipe_config(len(vocab))
    with open(os.path.join(root, "chars.txt"), "w") as f:
        f.write("\n".join(vocab.tokens) + "\n")
    t0 = time.perf_counter()
    train_lst = write_list(np, root, "train", random_utts(
        np, SEED, cfg.data.bucket_boundaries, DATA_PER_BUCKET, vocab), prepare)
    test_lst = write_list(np, root, "test", random_utts(
        np, SEED + 1, cfg.data.bucket_boundaries, DATA_TEST_UTTS // 4, vocab), prepare)
    corpus = sum(os.path.getsize(os.path.join(root, "wav", f"train{i:04d}.wav"))
                 for i in range(4 * DATA_PER_BUCKET))
    print(f"data: {4 * DATA_PER_BUCKET} PCM16 wavs ({corpus / 1e6:.1f} MB, buckets "
          f"{cfg.data.bucket_boundaries} s) and {DATA_TEST_UTTS} test wavs written with "
          f"prepare lists in {time.perf_counter() - t0:.1f} s; card {card_line()}, "
          f"os.cpu_count() {os.cpu_count()}", flush=True)

    loader_rate(np, train_lst, vocab, cfg, 8)  # warm-up pass: page cache and the native build
    for threads in (0, 8):
        rate, wall = loader_rate(np, train_lst, vocab, cfg, threads)
        print(f"  loader alone, loader_threads {threads}: {rate:.1f} audio-s/s (one epoch, "
              f"{wall * 1e3:.1f} ms)", flush=True)

    libri = os.path.join(REPO, "configs", "librispeech_ctc_bigru.yaml")
    model_dir = os.path.join(root, "libri")
    lists = ["--set", f"data.train_list={train_lst}", "--set", f"data.dev_list={test_lst}",
             "--set", f"data.test_list={test_lst}", "--set",
             f"data.vocab_path={os.path.join(root, 'chars.txt')}", "--set",
             f"model_dir={model_dir}"]
    record = dict(steps=[], waits=[], requests=[])
    rss0 = rss_bytes()
    reset_launches()
    t0 = time.perf_counter()
    with traced_data_path(torch, record):
        out = run_cli(torch, ["-c", libri, "--mode", "train", *lists, "--set",
                              f"train.total_steps={DATA_STEPS}", "--set", "train.log_every=1"])
    wall = time.perf_counter() - t0
    counts = read_launches()
    rss1 = rss_bytes()
    steps = record["steps"]
    check(len(steps) == DATA_STEPS, f"{len(steps)} training steps ran")
    losses = [float(x) for x in re.findall(r"\[train\] step \d+: loss=([0-9.e+-]+|nan|inf)", out)]
    print(f"  librispeech_ctc_bigru from disk through the CLI ({cfg.model.dtype}, H="
          f"{cfg.model.hidden_size} x{cfg.model.num_gru_layers}, B={cfg.data.batch_size}): "
          f"{DATA_STEPS} steps in {wall:.2f} s (start-up included); losses {losses}", flush=True)
    want = dict.fromkeys(counts, 0)
    want.update({"K1": 1, "K2": 3, "K2-bwd": 3, "K2-bwd:coeffs": 3, "K3": 1, "K3-bwd": 1,
                 "K-adam": 2})
    for i, (st, wait) in enumerate(zip(steps, record["waits"])):
        print(f"  step {i + 1} {st['shape'][1] / 16000:5.2f} s bucket: wall {st['wall'] * 1e3:.2f} "
              f"ms, waited {wait * 1e3:.2f} ms on the stream, RSS {st['rss'] / 1e6:.1f} MB",
              flush=True)
        check(st["launches"] == want, f"step {i + 1}: launches {st['launches']}, expected {want}")
    check(len(losses) == DATA_STEPS and all(np.isfinite(losses)), f"losses {losses}")
    check(counts == {k: v * DATA_STEPS for k, v in want.items()}, f"train launches {counts}")
    waits = record["waits"][: len(steps)]
    walls = [st["wall"] for st in steps]
    # growth after the first step, whose set-up (in a fresh process the CUDA
    # context and libraries) does not depend on the data
    base, peak = steps[0]["rss"], max(st["rss"] for st in steps[1:])
    print(f"  steps 2-{DATA_STEPS}: wall mean {np.mean(walls[1:]) * 1e3:.2f} ms, waited on the "
          f"stream {np.sum(waits[1:]) * 1e3:.2f} ms of {np.sum(walls[1:]) * 1e3:.2f} ms stepping "
          f"(first next() {waits[0] * 1e3:.2f} ms); RSS growth over the run "
          f"{(rss1 - rss0) / 1e6:.1f} MB, after the first step {(rss1 - base) / 1e6:.1f} MB "
          f"(peak {(peak - base) / 1e6:.1f} MB), corpus {corpus / 1e6:.1f} MB; card "
          f"{card_line()}", flush=True)
    check(rss1 - base < corpus, f"RSS grew {(rss1 - base) / 1e6:.1f} MB after the first step, "
          f"more than the corpus ({corpus / 1e6:.1f} MB)")

    record = dict(steps=[], waits=[], requests=[])
    reset_launches()
    t0 = time.perf_counter()
    with traced_data_path(torch, record):
        out = run_cli(torch, ["-c", libri, "--mode", "infer", *lists])
    wall = time.perf_counter() - t0
    counts = read_launches()
    reqs = record["requests"]
    print(f"  --mode infer (beam {cfg.ctc.beam_width}) from disk, {len(reqs)} requests in "
          f"{wall:.2f} s: {out.strip()}; launches {counts}", flush=True)
    check(out.startswith(f"step {DATA_STEPS}: PER="), f"infer printed {out!r}")
    want = dict.fromkeys(counts, 0)
    want.update({"K1": 1, "K2": 3, "K4": 1})
    for i, r in enumerate(reqs):
        check(r["launches"] == want, f"request {i}: launches {r['launches']}, expected {want}")
    check(len(reqs) > 0 and counts == {k: v * len(reqs) for k, v in want.items()},
          f"infer launches {counts}")
    for i, r in enumerate(reqs):
        plain = batch_edit_distance(r["refs"], r["ref_len"], r["hyps"], r["hyp_len"])
        t0 = time.perf_counter()
        nat = batch_edit_distance_native(*(x.cpu().numpy() for x in
                                           (r["refs"], r["ref_len"], r["hyps"], r["hyp_len"])))
        ms = (time.perf_counter() - t0) * 1e3
        check(plain.is_cuda and np.array_equal(plain.cpu().numpy(), nat),
              f"request {i}: native edit distance {nat} != torch on the card {plain}")
        print(f"  request {i}: native edit distance == torch batch_edit_distance on the card "
              f"for {len(nat)} pairs ({int(nat.sum())} edits, {ms:.2f} ms on the host)",
              flush=True)

    phones = sorted(TIMIT_61_TO_39) + TIMIT_SELF
    check(len(set(phones)) == 61, f"{len(set(phones))} TIMIT phones")
    with open(os.path.join(root, "phones61.txt"), "w") as f:
        f.write("\n".join(phones) + "\n")
    from uasr_torch.data.dataset import make_synthetic_dataset

    examples, _ = make_synthetic_dataset(num_utts=TIMIT_UTTS, num_phones=61, seed=SEED)
    timit_lst = write_list(np, root, "timit", [(a, [phones[i - 1] for i in ids])
                                               for a, ids in examples], prepare)
    timit = ["-c", os.path.join(REPO, "configs", "timit_ctc_mini.yaml"), "--set",
             f"data.train_list={timit_lst}", "--set", f"data.dev_list={timit_lst}", "--set",
             f"data.test_list={timit_lst}", "--set",
             f"data.vocab_path={os.path.join(root, 'phones61.txt')}", "--set",
             f"model_dir={os.path.join(root, 'timit')}"]
    reset_launches()
    t0 = time.perf_counter()
    out = run_cli(torch, [*timit, "--mode", "train", "--set", f"train.total_steps={TIMIT_STEPS}",
                          "--set", "train.log_every=1"])
    out += run_cli(torch, [*timit, "--mode", "infer"])
    counts = read_launches()
    hit = re.search(r"PER=([0-9.]+) PER_folded=([0-9.]+|nan)", out)
    print(f"  timit_ctc_mini from a {TIMIT_UTTS}-utterance list of 61 phones: {TIMIT_STEPS} "
          f"steps and --mode infer in {time.perf_counter() - t0:.2f} s: "
          f"{out.strip().splitlines()[-1]}; launches {counts}", flush=True)
    check(hit is not None and np.isfinite(float(hit.group(2))), f"no finite PER_folded in {out!r}")
    check(counts["K1"] > TIMIT_STEPS, f"timit launches {counts}")
    print(f"  data phase: {time.perf_counter() - t_phase:.1f} s", flush=True)


# the LM decode phase: text corpora for the n-gram tables (LM_SEQS random
# sentences of up to 20 tokens), the formant39 Viterbi corpus (VIT_UTTS
# utterances, five batches of 32: four probe the dwell rates; every row of
# every batch is decoded again on the CPU, ~7 s a trigram batch)
LM_SEQS, VIT_UTTS = 2000, 160
# the streaming LM's per-token bonus: lm_weight * log V offsets the cost a
# near-uniform V = 4233 table adds to each emitted token, so the fused beam
# emits at about the rate the beam without it does
STREAM_LM_BONUS = round(0.5 * math.log(STREAM_V), 4)


def write_text(path: str, seqs) -> None:
    with open(path, "w") as f:
        f.writelines(" ".join(s) + "\n" for s in seqs)


def write_arpa(path: str, seqs) -> None:
    """An ARPA trigram model of ``seqs`` (lists of token strings): add-one
    unigrams, maximum-likelihood bigrams and trigrams of the observed
    n-grams, fixed backoff weights (log10 -0.4 and -0.3)."""
    from collections import Counter

    c1, c2, c3 = Counter(), Counter(), Counter()
    for s in seqs:
        w = ["<s>", *s, "</s>"]
        c1.update(w[1:])
        c2.update(zip(w, w[1:]))
        c3.update(zip(w, w[1:], w[2:]))
    h1, h2 = Counter(), Counter()
    for (a, _), n in c2.items():
        h1[a] += n
    for (a, b, _), n in c3.items():
        h2[a, b] += n
    n1 = sum(c1.values()) + len(c1)
    uni = [f"{math.log10((n + 1) / n1):.6f}\t{w}\t-0.400000" for w, n in sorted(c1.items())]
    uni.append("-99.000000\t<s>\t-0.400000")
    bi = [f"{math.log10(n / h1[a]):.6f}\t{a} {b}\t-0.300000" for (a, b), n in sorted(c2.items())]
    tri = [f"{math.log10(n / h2[a, b]):.6f}\t{a} {b} {c}" for (a, b, c), n in sorted(c3.items())]
    with open(path, "w") as f:
        f.write(f"\\data\\\nngram 1={len(uni)}\nngram 2={len(bi)}\nngram 3={len(tri)}\n\n")
        for n, lines in ((1, uni), (2, bi), (3, tri)):
            f.write(f"\\{n}-grams:\n" + "\n".join(lines) + "\n\n")
        f.write("\\end\\\n")


def random_seqs(np, seed: int, tokens, n: int = LM_SEQS):
    rng = np.random.RandomState(seed)
    return [[tokens[j] for j in rng.randint(0, len(tokens), rng.randint(1, 21))]
            for _ in range(n)]


def prepare_quiet(prepare, argv) -> None:
    with contextlib.redirect_stdout(io.StringIO()):
        check(prepare.main(argv) == 0, f"prepare {argv[0]}")


@contextlib.contextmanager
def recorded_beam(torch, module, record: list):
    """Wrap ``module.ctc_beam_steps`` (K4's dispatcher as ``module`` calls
    it): each call's arguments, tensors copied, the start state included."""
    orig = module.ctc_beam_steps

    def steps(*args, state=None):
        record.append((tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args),
                       None if state is None else type(state)(*(x.clone() for x in state))))
        return orig(*args, state=state)

    module.ctc_beam_steps = steps
    try:
        yield
    finally:
        module.ctc_beam_steps = orig


def expect_each(records: list, want: dict, what: str) -> None:
    for i, r in enumerate(records):
        check(r["launches"] == want, f"{what} request {i}: launches {r['launches']}, "
                                     f"expected {want}")


def k4_lm_timing(torch, k4, args, state, what: str) -> str:
    """K4 on a recorded call of the path against its plain version
    (check_beam), its time and its bound (the table's rows this call's
    histories reach, not the whole table)."""
    logp, lengths, W, blank, table, order = args[:6]
    B, T, V = logp.shape
    check(table is not None and order in (2, 3), f"{what}: K4 ran without the table")
    res, ref = check_beam(torch, k4, args, what, state=state)
    ms = cuda_ms(torch, lambda: k4.ctc_beam_cuda(*args, state=state), 10)
    rows = lm_rows(torch, ref, state, lengths, V, order)
    bms, by = beam_bound(lengths, T, B, W, V, rows * V, order)
    return (f"{what} T={T} B={B} W={W} V={V}, {order}-gram table {tuple(table.shape)}: "
            f"backpointers, state and ids equal to the plain version, score max|d| "
            f"{res['max_abs_err']:.3e}; kernel {ms:.4f} ms ({beam_plan(k4, ms, lengths)}) "
            f"bound {bms:.6f} ms ({by}; {rows} of the table's {table.shape[0]} rows read, "
            f"{rows * V * 4 / 1e6:.2f} MB)")


def phase_lm_offline(torch, np, root: str, tables: dict) -> None:
    """Path 1: configs/librispeech_ctc_bigru.yaml at full width decoded by
    run_inference with ctc.use_beam and ctc.lm_path, once with the bigram
    table (`prepare lm`) and once with the trigram (`prepare import-arpa`):
    four requests of 32 (4-16 s), 1 K1, 3 K2 and 1 K4 each; K4 on each
    request's log-probs bit-equal to its plain version with each table."""
    from uasr_torch import infer
    from uasr_torch.frontend.features import make_frontend_state
    from uasr_torch.models.models import build_model
    from uasr_torch.ops import cuda_beam as k4
    from uasr_torch.ops import decode as decode_mod

    dev = torch.device(DEVICE)
    vocab = char_vocab()
    cfg = recipe_config(len(vocab))
    model = build_model(cfg.model, cfg.dim_output, cfg.frontend.dim_input,
                        generator=torch.Generator().manual_seed(SEED), device=dev)
    fstate = make_frontend_state(cfg.frontend, device=dev)
    requests = make_requests(np, cfg)
    want = dict.fromkeys(read_launches(), 0)
    want.update({"K1": 1, "K2": cfg.model.num_gru_layers, "K4": 1})
    for order, path in tables.items():
        run_cfg = cfg.replace(ctc=dataclasses.replace(cfg.ctc, lm_path=path))
        rec, calls = dict(steps=[], waits=[], requests=[]), []
        reset_launches()
        with traced_data_path(torch, rec), recorded_beam(torch, decode_mod, calls):
            r = infer.run_inference(run_cfg, model, fstate, requests, vocab=vocab, device=dev)
        reqs = rec["requests"]
        counts = read_launches()
        check(infer.LAST_BEAM_IMPL == "cuda", f"LM beam ran {infer.LAST_BEAM_IMPL}")
        check(np.isfinite(r["per"]) and r["ref_tokens"] > 0, f"LM beam: bad score {r}")
        expect_each(reqs, want, f"{order}-gram beam")
        check(counts == {k: v * len(requests) for k, v in want.items()},
              f"{order}-gram beam launches {counts}")
        wall = r["rtf"] * r["audio_seconds"]
        print(f"lm offline: {cfg.name} beam {cfg.ctc.beam_width}, lm_weight "
              f"{cfg.ctc.lm_weight}, {order}-gram {os.path.basename(path)}: "
              f"{len(requests)} requests in {wall * 1e3:.2f} ms ("
              + ", ".join(f"{b.audio.shape[1] / 16000:.0f} s {q['wall'] * 1e3:.2f} ms"
                          for b, q in zip(requests, reqs))
              + f"), {r['audio_seconds'] / wall:.1f} audio-s/s, PER {r['per']:.3f}; launches "
              f"{counts}", flush=True)
        check(len(calls) == len(requests) and all(a[5] == order for a, _ in calls),
              f"K4 calls recorded: {[a[5] for a, _ in calls]}")
        t0 = time.perf_counter()
        for i, (args, state) in enumerate(calls[:-1]):  # the last one below, timed
            check_beam(torch, k4, args, f"{order}-gram request {i}", state=state)
        print("  " + k4_lm_timing(torch, k4, *calls[-1], f"K4 {order}-gram, 16 s request")
              + f"; the {len(calls)} requests' checks against the plain version "
              f"{time.perf_counter() - t0:.2f} s", flush=True)


def phase_lm_stream(torch, np, path: str) -> None:
    """Path 2: configs/aishell_streaming.yaml at full width (cnn, V = 4233
    stand-in, beam 8) with a bigram [4234, 4233] table through
    StreamingRecognizer over the stream phase's 64 streams (1 K7 and 1 K4
    a step, the table carried chunk to chunk), finals against the port's
    offline LM beam of the same audio; K4 on two of the steps' recorded
    inputs bit-equal to its plain version, timed; then the daemon for two
    rounds with the table."""
    from uasr_torch import serve
    from uasr_torch.frontend.features import make_frontend_state
    from uasr_torch.models.models import build_model
    from uasr_torch.ops import cuda_beam as k4
    from uasr_torch.serve import StreamingRecognizer

    dev = torch.device(DEVICE)
    cfg = aishell_config()
    cfg = cfg.replace(ctc=dataclasses.replace(cfg.ctc, lm_path=path, lm_bonus=STREAM_LM_BONUS))
    vocab = aishell_vocab()
    model = build_model(cfg.model, cfg.dim_output, cfg.frontend.dim_input,
                        generator=torch.Generator().manual_seed(SEED), device=dev)
    fstate = make_frontend_state(cfg.frontend, device=dev)
    batch = make_streams(np, cfg, STREAM_B, SEED + 3)
    calibrate_blank(torch, cfg, model, fstate, batch, dev)
    t0 = time.perf_counter()
    ref = offline_ids(cfg, model, fstate, batch, vocab, dev, use_beam=True)
    off_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rec = StreamingRecognizer(cfg, model, device=dev)
    load_s = time.perf_counter() - t0
    check(rec.lm_order == 2 and tuple(rec.lm_table.shape) == (STREAM_V + 1, STREAM_V),
          f"recognizer table {rec.lm_order} {tuple(rec.lm_table.shape)}")
    want = dict.fromkeys(read_launches(), 0)
    want.update({"K7": 1, "K4": 1})
    steps = 0

    def per_step(d):
        nonlocal steps
        steps += 1
        check(d == want, f"LM stream step launches {d}, expected {want}")

    calls = []
    reset_launches()
    t0 = time.perf_counter()
    with recorded_beam(torch, serve, calls):
        _, final, lat, _ = stream_batch(torch, np, rec, batch, per_step)
    wall = time.perf_counter() - t0
    counts = read_launches()
    check(counts["K7"] == steps and counts["K4"] == steps + 1, f"LM stream launches {counts}")
    cap = cfg.data.max_label_len
    bad = [b for b in range(STREAM_B) if final[b] != ref[b][:cap]]
    secs = float(np.sum(batch.audio_lengths)) / cfg.frontend.sample_rate
    print(f"lm stream: {cfg.name} cnn, V={cfg.dim_output}, beam {cfg.ctc.beam_width}, bigram "
          f"table {tuple(rec.lm_table.shape)}, lm_weight {cfg.ctc.lm_weight} lm_bonus "
          f"{cfg.ctc.lm_bonus} ({rec.lm_table.numel() * 4 / 1e6:.1f} MB, loaded "
          f"onto the card in {load_s * 1e3:.1f} ms); {STREAM_B} streams, {steps} steps + "
          f"finish in {wall:.3f} s ({secs:.1f} s of audio); finals == offline LM beam for "
          f"{STREAM_B - len(bad)} of {STREAM_B} (offline decode {off_s:.3f} s, "
          f"{np.mean([len(x) for x in ref]):.1f} tokens per stream); launches {counts}",
          flush=True)
    check(not bad, f"LM streams {bad[:8]} differ from the offline LM beam")
    report_latency(np, f"B={STREAM_B}, bigram LM", lat[1:], STREAM_B,
                   rec.chunk_samples / cfg.frontend.sample_rate)
    for i in (1, len(calls) // 2):
        print("  " + k4_lm_timing(torch, k4, *calls[i], f"K4 bigram, streaming step {i}"),
              flush=True)
    args, state = calls[len(calls) // 2]
    plain = cuda_ms(torch, lambda: k4.ctc_beam_reference(*args, state=state), 1, warmup=0)
    print(f"  K4 bigram streaming step plain version {plain:.4f} ms", flush=True)
    st = rec.init(STREAM_B, batch.audio_lengths)
    cs = rec.chunk_samples
    mid = batch.audio.shape[1] // cs // 2
    for k in range(mid):
        st, _, _ = rec.step(st, batch.audio[:, k * cs:(k + 1) * cs])
    profile_call(torch, lambda: rec.step(st, batch.audio[:, mid * cs:(mid + 1) * cs])[1].cpu(),
                 f"one streaming step of {STREAM_B} streams with the bigram LM")
    phase_daemon(torch, np, "cnn", rounds=2, lm_path=path)


def phase_lm_viterbi(torch, np, root: str) -> None:
    """Path 3: configs/formant39_unsup.yaml at full width (classifier 384 x
    2, V = 41, merge_repeats; random weights) decoded by run_inference
    through GeneratorInfer.logits_fn with ctc.use_viterbi over a bigram and
    a trigram table from `prepare lm` on the corpus text: the dwell rates
    calibrated on four probe batches, 1 K1 per decoded batch (and per
    probe); each batch's Viterbi on the card against the same decoder on
    CPU copies of its logits."""
    from uasr_torch import infer, train
    from uasr_torch.config import load_config
    from uasr_torch.data.dataset import batch_iterator
    from uasr_torch.ops import viterbi
    from uasr_torch.tools import prepare

    dev = torch.device(DEVICE)
    cfg = load_config(os.path.join(REPO, "configs", "formant39_unsup.yaml"))
    examples, vocab = unsup_corpus(cfg, VIT_UTTS, seed=SEED + 7)
    text, vocab_path = os.path.join(root, "f39_text.txt"), os.path.join(root, "f39_vocab.txt")
    write_text(text, [vocab.decode(ids) for _, ids in examples])
    with open(vocab_path, "w") as f:
        f.write("\n".join(vocab.tokens) + "\n")
    ginf = train.GeneratorInfer(cfg, device=dev)
    batches = list(batch_iterator(examples, cfg.data.batch_size,
                                  int(cfg.data.max_audio_seconds * cfg.frontend.sample_rate),
                                  cfg.data.max_label_len, shuffle=False, num_epochs=1,
                                  drop_remainder=False))
    want = dict.fromkeys(read_launches(), 0)
    want["K1"] = 1
    make = viterbi.make_lm_decoder
    for order in (2, 3):
        lm = os.path.join(root, f"f39_lm{order}.npz")
        prepare_quiet(prepare, ["lm", "--text", text, "--vocab", vocab_path, "--order",
                                str(order), "--out", lm])
        run_cfg = cfg.replace(ctc=dataclasses.replace(cfg.ctc, use_viterbi=True, lm_path=lm))
        made, runs = [], []

        def recording(table, blank_id, self_loop, blank_prob, device):
            made.append((self_loop, blank_prob))
            fn = make(table, blank_id, self_loop, blank_prob, device)

            def decode(logits, lengths):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(logits, lengths)
                torch.cuda.synchronize()
                runs.append(dict(wall=time.perf_counter() - t0, logits=logits.clone(),
                                 lengths=lengths.clone(), out=[x.clone() for x in out]))
                return out

            return decode

        rec = dict(steps=[], waits=[], requests=[])
        viterbi.make_lm_decoder = recording
        reset_launches()
        try:
            with traced_data_path(torch, rec):
                r = infer.run_inference(run_cfg, ginf.gen, ginf.frontend_state, batches,
                                        vocab=vocab, device=dev, logits_fn=ginf.logits_fn)
        finally:
            viterbi.make_lm_decoder = make
        reqs = rec["requests"]
        counts = read_launches()
        n = len(batches)
        check(np.isfinite(r["per"]) and r["ref_tokens"] > 0, f"viterbi: bad score {r}")
        expect_each(reqs, want, f"{order}-gram Viterbi")
        check(counts == dict(want, K1=n + min(4, n)), f"{order}-gram Viterbi launches {counts}")
        check(len(made) == 1 and len(runs) == n, f"{len(made)} decoders, {len(runs)} decodes")
        sl, bp = made[0]
        t_cpu = time.perf_counter()
        cpu = make(np.load(lm)["logp"], cfg.ctc.blank_id, sl, bp, "cpu")
        worst = 0.0
        for i, run in enumerate(runs):
            ids, k, score = (x.cpu() for x in run["out"])
            r_ids, r_k, r_score = cpu(run["logits"].cpu(), run["lengths"].cpu())
            check(torch.equal(ids, r_ids) and torch.equal(k, r_k),
                  f"{order}-gram batch {i}: card ids differ from the CPU's")
            rel = float(((score - r_score).abs() / r_score.abs().clamp_min(1e-30)).max())
            worst = max(worst, rel)
            check(rel <= 1e-5, f"{order}-gram batch {i}: score rel {rel:.3e}")
        t_cpu = time.perf_counter() - t_cpu
        wall = r["rtf"] * r["audio_seconds"]
        vit = sum(x["wall"] for x in runs)
        T = max(int(x["logits"].shape[1]) for x in runs)
        print(f"lm viterbi: {cfg.name} classifier {cfg.model.classifier_hidden} x "
              f"{cfg.model.classifier_layers}, V={cfg.dim_output}, merged stream (T up to {T}), "
              f"{order}-gram table from prepare lm: rates calibrated on {min(4, n)} probe "
              f"batches self_loop {sl:.6f} blank_prob {bp:.6f}; {n} batches of "
              f"{cfg.data.batch_size} decoded in {wall * 1e3:.2f} ms, Viterbi {vit * 1e3:.2f} ms "
              f"of it ({vit / wall:.1%}), {r['audio_seconds'] / wall:.1f} audio-s/s, PER "
              f"{r['per']:.3f}; card == CPU ids in every row of all {n} batches, score rel "
              f"max {worst:.2e} (the CPU's decodes {t_cpu:.2f} s); launches {counts}",
              flush=True)


def collapsed_alignments(utts, vocab, total: int = 4, max_label: int = 256) -> tuple[int, int]:
    """(utterances whose transcript fits its logits frames, those of them
    whose alignment collapses back to the transcript). ``total`` is the
    frames per logits frame (frontend.downsample 1 x two stride-2 convs)."""
    fits = ok = 0
    for u in utts:
        lab = vocab.encode(u.tokens)[:max_label]
        track = vocab.encode(u.align_tokens)
        check(len(track) % total == 0, f"{u.utt_id}: {len(track)} frames")
        frames = track[::total]
        if len(frames) < len(lab) + sum(a == b for a, b in zip(lab, lab[1:])):
            continue
        fits += 1
        merged = [t for i, t in enumerate(frames) if t != 0 and (i == 0 or t != frames[i - 1])]
        ok += merged == lab
    return fits, ok


def run_align(torch, argv: list) -> tuple[float, list, str]:
    """``python -m uasr_torch.tools.align``'s main in process, each batch's
    ``ctc_forced_align`` timed alone (synchronised around it): (wall,
    [(seconds, logits shape, labels shape)] a batch, the tool's last
    line on stderr)."""
    from uasr_torch.ops import viterbi
    from uasr_torch.tools import align

    forced, fa = viterbi.ctc_forced_align, []

    def timed_align(logits, lengths, labels, label_lengths, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = forced(logits, lengths, labels, label_lengths, **kw)
        torch.cuda.synchronize()
        fa.append((time.perf_counter() - t, tuple(logits.shape), tuple(labels.shape)))
        return out

    viterbi.ctc_forced_align = timed_align
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stderr(io.StringIO()) as err:
            rc = align.main(argv)
        torch.cuda.synchronize()
    finally:
        viterbi.ctc_forced_align = forced
    check(rc == 0, f"align exit {rc}")
    return time.perf_counter() - t0, fa, err.getvalue().strip().splitlines()[-1]


def phase_lm_cli(torch, np, root: str) -> None:
    """Path 3 through the CLI and path 4: configs/timit_ctc_mini.yaml's
    checkpoint from the data phase decoded by `--mode infer --set
    ctc.use_viterbi=true --set ctc.lm_path=...` (a bigram from `prepare lm`
    on the list's transcripts; 1 K1 per batch and probe), and
    ``python -m uasr_torch.tools.align``'s main on the data phase's
    librispeech_ctc_bigru checkpoint over its 64-utterance test list (B =
    32, 16 s; 1 K1 and 3 K2 per batch): every utterance whose transcript
    fits its frames collapses back to its transcript; each batch's
    ctc_forced_align timed alone, synchronised around it."""
    import re

    from uasr_torch.data.io import read_utterance_list
    from uasr_torch.tools import prepare
    from uasr_torch.vocab import load_vocab

    timit_lst = os.path.join(root, "timit.tsv")
    phones = os.path.join(root, "phones61.txt")
    text = os.path.join(root, "timit_text.txt")
    write_text(text, [u.tokens for u in read_utterance_list(timit_lst)])
    lm = os.path.join(root, "timit_lm2.npz")
    prepare_quiet(prepare, ["lm", "--text", text, "--vocab", phones, "--out", lm])
    rec = dict(steps=[], waits=[], requests=[])
    reset_launches()
    t0 = time.perf_counter()
    with traced_data_path(torch, rec):
        out = run_cli(torch, ["-c", os.path.join(REPO, "configs", "timit_ctc_mini.yaml"),
                              "--mode", "infer", "--set", f"data.test_list={timit_lst}",
                              "--set", f"data.vocab_path={phones}", "--set",
                              f"model_dir={os.path.join(root, 'timit')}", "--set",
                              "ctc.use_viterbi=true", "--set", f"ctc.lm_path={lm}"])
    wall = time.perf_counter() - t0
    counts = read_launches()
    reqs = rec["requests"]
    want = dict.fromkeys(counts, 0)
    want["K1"] = 1
    expect_each(reqs, want, "timit Viterbi")
    n = len(reqs)
    check(n > 0 and counts == dict(want, K1=n + min(4, n)), f"timit Viterbi launches {counts}")
    hit = re.search(r"PER=([0-9.]+) PER_folded=([0-9.]+|nan)", out)
    check(hit is not None and np.isfinite(float(hit.group(2))), f"timit Viterbi printed {out!r}")
    shape = tuple(np.load(lm)["logp"].shape)
    print(f"lm cli: timit_ctc_mini --mode infer with ctc.use_viterbi over a bigram {shape}: "
          f"{n} batches in {wall:.2f} s (decode {sum(q['wall'] for q in reqs) * 1e3:.2f} ms): "
          f"{out.strip()}; launches {counts}", flush=True)

    libri = os.path.join(REPO, "configs", "librispeech_ctc_bigru.yaml")
    test_lst = os.path.join(root, "test.tsv")
    chars = os.path.join(root, "chars.txt")
    out_lst = os.path.join(root, "test_aligned.tsv")
    reset_launches()
    wall, fa, last = run_align(torch, ["-c", libri, "--split", "test", "--out", out_lst, "--set",
                                       f"data.test_list={test_lst}", "--set",
                                       f"data.vocab_path={chars}", "--set",
                                       f"model_dir={os.path.join(root, 'libri')}"])
    counts = read_launches()
    utts = read_utterance_list(out_lst)
    nb = -(-len(utts) // 32)
    want = dict.fromkeys(counts, 0)
    want.update({"K1": nb, "K2": 3 * nb})
    check(counts == want, f"align launches {counts}, expected {want}")
    check(len(fa) == nb, f"{len(fa)} forced alignments for {nb} batches")
    fits, ok = collapsed_alignments(utts, load_vocab(chars))
    print(f"lm align: tools.align on librispeech_ctc_bigru (the data phase's step-"
          f"{DATA_STEPS} checkpoint), {len(utts)} utterances in {nb} batches of 32 at 16 s in "
          f"{wall:.2f} s (ctc_forced_align " + ", ".join(
              f"{ms * 1e3:.2f} ms on logits {lg} labels {lb}" for ms, lg, lb in fa)
          + f"); {last}; {fits} fit their frames, "
          f"{ok} of them collapse to their transcript; launches {counts}", flush=True)
    check(fits > 0 and ok == fits, f"alignments: {ok} of {fits} collapse to the transcript")


def phase_lm_decode(torch, np, root: str) -> None:
    """Paths 1-4 of the LM and HMM decode slice (after phase_data, whose
    checkpoints and lists under ``root`` paths 3 and 4 read)."""
    from uasr_torch.tools import prepare

    t_phase = time.perf_counter()
    chars = os.path.join(root, "chars.txt")
    letters = char_vocab().tokens[1:29]
    text = os.path.join(root, "lm_text.txt")
    seqs = random_seqs(np, SEED + 11, letters)
    write_text(text, seqs)
    arpa = os.path.join(root, "lm.arpa")
    write_arpa(arpa, seqs)
    tables = {2: os.path.join(root, "lm2.npz"), 3: os.path.join(root, "lm3.npz")}
    prepare_quiet(prepare, ["lm", "--text", text, "--vocab", chars, "--order", "2", "--out",
                            tables[2]])
    prepare_quiet(prepare, ["import-arpa", "--arpa", arpa, "--vocab", chars, "--order", "3",
                            "--out", tables[3]])
    t0 = time.perf_counter()
    phase_lm_offline(torch, np, root, tables)
    print(f"  path 1: {time.perf_counter() - t0:.1f} s", flush=True)

    vocab = aishell_vocab()
    with open(os.path.join(root, "chars4233.txt"), "w") as f:
        f.write("\n".join(vocab.tokens) + "\n")
    write_text(os.path.join(root, "lm_text4233.txt"),
               random_seqs(np, SEED + 12, vocab.tokens[2:-1]))
    t0 = time.perf_counter()
    big = os.path.join(root, "lm4233.npz")
    prepare_quiet(prepare, ["lm", "--text", os.path.join(root, "lm_text4233.txt"), "--vocab",
                            os.path.join(root, "chars4233.txt"), "--out", big])
    print(f"lm stream table: prepare lm over {LM_SEQS} sentences, V={STREAM_V}: "
          f"{os.path.getsize(big) / 1e6:.1f} MB in {time.perf_counter() - t0:.2f} s", flush=True)
    phase_lm_stream(torch, np, big)
    print(f"  path 2 with the table's build: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    phase_lm_viterbi(torch, np, root)
    print(f"  path 3, formant39: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    phase_lm_cli(torch, np, root)
    print(f"  path 3 through the CLI and path 4: {time.perf_counter() - t0:.1f} s", flush=True)
    print(f"  lm decode phase: {time.perf_counter() - t_phase:.1f} s", flush=True)


# the frame-CE phase: steps of librispeech_ctc_bigru's frame-CE training
# through the CLI on the data phase's aligned train list
FCE_STEPS = 8
# F C C F turns of the frame-CE and the CTC step on one batch
FCE_TURNS = 3


def phase_frame_ce(torch, np, root: str, launches: dict) -> None:
    """Frame-CE training at full width (after phase_lm_decode, on the data
    phase's directory): ``tools.align`` over the 256-wav train list with
    the data phase's librispeech_ctc_bigru checkpoint; ``--set
    train.mode=frame_ce`` through the CLI on the aligned list for
    FCE_STEPS steps from a fresh model_dir (each step's wall, launches and
    frame_acc; 1 K1, 3 K2, 3 K2-bwd); the frame-CE step and the recipe's
    CTC step on the CLI's first batch, in turns, and a profile of each;
    that batch's loss and
    gradients on the kernel path against the plain path; ``--mode infer``
    of the frame-CE checkpoint; and ``tools.align`` on the frame-CE
    checkpoint, every alignment that fits its frames collapsing to its
    transcript."""
    from uasr_torch import cli, train
    from uasr_torch.config import load_config
    from uasr_torch.data.io import read_utterance_list
    from uasr_torch.vocab import load_vocab

    t_phase = time.perf_counter()
    dev = torch.device(DEVICE)
    libri = os.path.join(REPO, "configs", "librispeech_ctc_bigru.yaml")
    chars = os.path.join(root, "chars.txt")
    vocab = load_vocab(chars)
    train_al = os.path.join(root, "train_aligned.tsv")
    reset_launches()
    wall, fa, last = run_align(torch, ["-c", libri, "--split", "train", "--out", train_al,
                                       "--set", f"data.train_list={root}/train.tsv", "--set",
                                       f"data.vocab_path={chars}", "--set",
                                       f"model_dir={root}/libri"])
    counts = read_launches()
    utts = read_utterance_list(train_al)
    nb = -(-len(utts) // 32)
    want = dict.fromkeys(counts, 0)
    want.update({"K1": nb, "K2": 3 * nb})
    check(counts == want and len(fa) == nb, f"align launches {counts}, expected {want}")
    fits, ok = collapsed_alignments(utts, vocab)
    print(f"frame-ce: tools.align over the data phase's {len(utts)}-wav train list (its step-"
          f"{DATA_STEPS} librispeech_ctc_bigru checkpoint): {nb} batches of 32 at 16 s in "
          f"{wall:.2f} s with the restore, {wall / nb * 1e3:.1f} ms a batch; ctc_forced_align "
          f"alone {np.mean([f[0] for f in fa]) * 1e3:.2f} ms a batch (min "
          f"{min(f[0] for f in fa) * 1e3:.2f}, max {max(f[0] for f in fa) * 1e3:.2f}); {last}; "
          f"{ok} of {fits} fitting alignments collapse; launches {counts}", flush=True)
    check(fits > 0 and ok == fits, f"alignments: {ok} of {fits} collapse to the transcript")

    model_dir = os.path.join(root, "fce")
    lists = ["--set", f"data.train_list={train_al}", "--set",
             f"data.dev_list={root}/test_aligned.tsv", "--set", f"data.test_list={root}/test.tsv",
             "--set", f"data.vocab_path={chars}", "--set", f"model_dir={model_dir}", "--set",
             "train.mode=frame_ce"]
    record = dict(steps=[], waits=[], requests=[])
    reset_launches()
    t0 = time.perf_counter()
    with traced_data_path(torch, record):
        run_cli(torch, ["-c", libri, "--mode", "train", *lists, "--set",
                        f"train.total_steps={FCE_STEPS}", "--set", "train.log_every=1"])
    wall = time.perf_counter() - t0
    counts = read_launches()
    with open(os.path.join(model_dir, "metrics.jsonl")) as f:
        recs = [json.loads(ln) for ln in f if '"train"' in ln]
    steps = record["steps"]
    check(len(steps) == FCE_STEPS and len(recs) == FCE_STEPS,
          f"{len(steps)} steps ran, {len(recs)} logged")
    print(f"  frame-CE through the CLI (librispeech_ctc_bigru, bf16, H=512 x3, B=32, every "
          f"batch padded to 16 s): {FCE_STEPS} steps in {wall:.2f} s (start-up and the read of "
          f"the lists included)", flush=True)
    want = dict.fromkeys(counts, 0)
    want.update({"K1": 1, "K2": 3, "K2-bwd": 3, "K2-bwd:coeffs": 3, "K-adam": 2})
    for i, (st, r) in enumerate(zip(steps, recs)):
        print(f"  step {i + 1} {st['shape'][1] / 16000:5.2f} s batch: wall {st['wall'] * 1e3:.2f} "
              f"ms, loss {r['loss']:.4f}, frame_acc {r['frame_acc']:.4f}, launches "
              f"{ {k: v for k, v in st['launches'].items() if v} }", flush=True)
        check(st["launches"] == want, f"step {i + 1}: launches {st['launches']}, expected {want}")
        check(np.isfinite(r["loss"]) and 0.0 <= r["frame_acc"] <= 1.0, f"step {i + 1}: {r}")
    check(counts == {k: v * FCE_STEPS for k, v in want.items()}, f"train launches {counts}")
    for k in ("K1", "K2", "K2-bwd"):
        launches[k] += counts[k]

    # the frame-CE step beside the recipe's CTC step (K3, K3-bwd) on the
    # CLI's first batch, in turns F C C F after one step of each, each from
    # the same initial weights; then one profiled step of each
    cfg = load_config(libri)
    cli.apply_overrides(cfg, lists[1::2])
    cfg = cfg.replace(vocab_size=len(vocab))
    source, _ = cli._load_source(cfg, "train")
    it = cli._batches(cfg, source, seed=cfg.train.seed)
    first = next(it)
    it.close()
    trainers = {"frame_ce": train.CTCTrainer(cfg, device=dev),
                "ctc": train.CTCTrainer(cfg.replace(train=dataclasses.replace(cfg.train,
                                                                               mode="ctc")),
                                        device=dev)}
    init = {k: v.detach().clone() for k, v in trainers["ctc"].init_state().params.items()}
    db = trainers["frame_ce"].to_device(first)
    states = {k: t.init_state() for k, t in trainers.items()}
    walls: dict = {k: [] for k in trainers}

    def step(name):
        states[name], aux = trainers[name].train_step(states[name], db)
        return aux

    for i in range(2 + 4 * FCE_TURNS):
        name = ("frame_ce", "ctc", "ctc", "frame_ce")[i % 4] if i >= 2 else ("frame_ce", "ctc")[i]
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        aux = step(name)
        torch.cuda.synchronize()
        if i >= 2:
            walls[name].append(time.perf_counter() - t0)
        counts = {k: v for k, v in read_launches().items() if v}
        want = {"K1": 1, "K2": 3, "K2-bwd": 3, "K2-bwd:coeffs": 3, "K-adam": 2}
        if name == "ctc":
            want.update({"K3": 1, "K3-bwd": 1})
        check(counts == want and np.isfinite(float(aux["loss"])),
              f"{name} step: launches {counts}, loss {aux['loss']}")
    print(f"  {FCE_TURNS} x (F C C F) steps on the CLI's first batch ("
          f"{first.audio.shape[1] / 16000:.1f} s, B={len(first.audio)}), after one of each: "
          + "; ".join(f"{k} wall median {np.median(w) * 1e3:.2f} ms (min {min(w) * 1e3:.2f}, "
                      f"max {max(w) * 1e3:.2f})" for k, w in walls.items())
          + f"; card {card_line()}", flush=True)
    for name in trainers:
        profile_call(torch, lambda: step(name), f"one {name} step on that batch")
    compare_first_step(torch, cfg, init, db, "frame-CE step")

    record = dict(steps=[], waits=[], requests=[])
    reset_launches()
    t0 = time.perf_counter()
    with traced_data_path(torch, record):
        out = run_cli(torch, ["-c", libri, "--mode", "infer", *lists])
    wall = time.perf_counter() - t0
    counts = read_launches()
    reqs = record["requests"]
    want = dict.fromkeys(counts, 0)
    want.update({"K1": 1, "K2": 3, "K4": 1})
    expect_each(reqs, want, "frame-CE infer")
    check(len(reqs) > 0 and counts == {k: v * len(reqs) for k, v in want.items()},
          f"frame-CE infer launches {counts}")
    check(out.startswith(f"step {FCE_STEPS}: PER="), f"infer printed {out!r}")
    print(f"  --mode infer of the frame-CE checkpoint (beam {cfg.ctc.beam_width}), {len(reqs)} "
          f"requests in {wall:.2f} s: {out.strip()}", flush=True)
    for k in ("K1", "K2", "K4"):
        launches[k] += counts[k]

    out_lst = os.path.join(root, "test_aligned_fce.tsv")
    reset_launches()
    wall, fa, last = run_align(torch, ["-c", libri, "--split", "test", "--out", out_lst, *lists])
    counts = read_launches()
    utts = read_utterance_list(out_lst)
    nb = -(-len(utts) // 32)
    want = dict.fromkeys(counts, 0)
    want.update({"K1": nb, "K2": 3 * nb})
    check(counts == want and len(fa) == nb, f"align launches {counts}, expected {want}")
    fits, ok = collapsed_alignments(utts, vocab)
    print(f"  tools.align on the frame-CE checkpoint: {len(utts)} utterances in {nb} batches in "
          f"{wall:.2f} s; {last}; {fits} fit their frames, {ok} of them collapse to their "
          f"transcript", flush=True)
    check(fits > 0 and ok == fits, f"frame-CE alignments: {ok} of {fits} collapse")
    print(f"  frame-CE phase: {time.perf_counter() - t_phase:.1f} s", flush=True)


# SSL pretraining and the feature-cache path (configs/formant39_ssl.yaml and
# configs/wav2vecu_pod_stretch.yaml): the formant corpus is cut from the
# recipe's 2048 utterances to SSL_UTTS (a train list of 7/8 of them, B=256
# GAN batches drawn from it with repeats across epochs)
SSL_UTTS = 360
SSL_STEPS = 20  # pretraining steps at full width; the step wall is the last 10's median
SSL_SHORT = 4  # steps with input_type fbank and with the fused loss
SSL_T, SSL_B, SSL_H = 600, 16, 512  # K5 / K5-bwd at the context GRU's shape (6 s, 100 Hz)
SSL_SAMPLE_FRAMES = 2048  # featurize's pooling k-means reservoir (host k-means cost)
SSL_KMEANS_UTTS = 8  # cached utterances the segmenter's 128 centroids are fit on
GAN_ALTS = 8  # gan+eodm alternations over the cache
W2V_SELF_STEPS = 4  # student steps of the self-training round over the cache


@contextlib.contextmanager
def traced_methods(torch, methods: list, record: dict):
    """Wrap each (class, method name) so that every call's wall (ending in a
    synchronise) and launches are recorded under the method's name."""
    saved = [(cls, name, getattr(cls, name)) for cls, name in methods]

    def wrap(name, orig):
        def fn(*a, **k):
            before = read_launches()
            t0 = time.perf_counter()
            out = orig(*a, **k)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            after = read_launches()
            record.setdefault(name, []).append(
                dict(wall=wall, launches={k: after[k] - before[k] for k in after if
                                          after[k] != before[k]}))
            return out
        return fn

    for cls, name, orig in saved:
        setattr(cls, name, wrap(name, orig))
    try:
        yield
    finally:
        for cls, name, orig in saved:
            setattr(cls, name, orig)


@contextlib.contextmanager
def timed_gathers(torch, record: list):
    """The host time of each batch of ``data.cache.device_feature_batches``
    (the first one also builds and uploads the corpus; the others issue the
    row gathers, which the card runs in stream order behind the training
    step's kernels, so no synchronise: the prefetch thread issues them
    while the step runs)."""
    from uasr_torch.data import cache

    orig = cache.device_feature_batches

    def batches(*a, **k):
        it = orig(*a, **k)
        while True:
            t0 = time.perf_counter()
            try:
                b = next(it)
            except StopIteration:
                return
            record.append(time.perf_counter() - t0)
            yield b

    cache.device_feature_batches = batches
    try:
        yield
    finally:
        cache.device_feature_batches = orig


def ssl_kernels(torch, np) -> None:
    """K5 forward at the SSL context GRU's shape (G = 1, T = 600, B = 16,
    H = 512, f32; larger than any earlier K5 case), ragged and every row
    live, against its plain version, timed beside cuDNN's GRU; and K5-bwd /
    K8 at the same shape (gru_bwd_case)."""
    from uasr_torch.models import cuda_gru as k5

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 20)
    T, rows, H = SSL_T, SSL_B, SSL_H
    gru = torch.nn.GRU(H, H).to(dev)
    gru.flatten_parameters()
    x = torch.randn(T, rows, H, device=dev, generator=gen)
    with torch.inference_mode():
        lib = cuda_ms(torch, lambda: gru(x), 20)
    for full in (False, True):
        (xp, wh, bh), tmask, _, lengths = _gru_problem(torch, gen, T, rows, H, torch.float32,
                                                       full)
        args = (xp, wh, bh, tmask)
        got = k5.gru_scan_cuda(*args)
        plan = (k5.LAST_GRU_WH, *k5.LAST_GRU_PLAN)
        ref = k5.gru_scan_reference(*args)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        tag = "ssl:full" if full else "ssl"
        check(bool(torch.isfinite(got).all()), f"K5 {tag}: non-finite output")
        check(err <= 1e-4, f"K5 {tag}: max|d| {err:.3e} > 1e-4")
        check(not bool(got[:, 0, lengths == 0].any()), f"K5 {tag}: a zero-length row moved")
        ms = cuda_ms(torch, lambda: k5.gru_scan_cuda(*args), 20)
        plain = cuda_ms(torch, lambda: k5.gru_scan_reference(*args), 2)
        steps = int(lengths.sum())
        nbytes = 4 * (T * rows * 3 * H + H * 3 * H + 3 * H + T * rows * H) + 4 * T * rows
        bms, by = bound(nbytes, 2 * steps * H * 3 * H, "float32")
        print(f"K5 gru     {tag:12s} T={T} B={rows} H={H} (wh, units/CTA, splits)={plan}: "
              f"max|d| {err:.3e} (tol 1e-4) kernel {ms:.4f} ms plain {plain:.4f} ms cuDNN GRU "
              f"{lib:.4f} ms bound {bms:.4f} ms ({by})", flush=True)
    gru_bwd_case(torch, gen, "ssl", T, rows, H, "float32")


def ssl_first_step(torch, cfg, batch, what: str):
    """The first SSL step's loss, grad norm and worst gradient tensor on the
    kernel path against the plain path, from the same initial weights,
    batch and negatives, at the training-step bars (f32: loss and grad norm
    rel 1e-4, worst tensor |dg|/|g| 1e-3). Returns (trainer, its initial
    parameters, the batch on the card)."""
    from uasr_torch import pretrain
    from uasr_torch.ops import cuda_adam

    t = pretrain.SSLTrainer(cfg, device=torch.device(DEVICE))
    params = t.init_state().params
    db = t.to_device(batch)
    aux_k, g_k = t.loss_and_grads(params, db, t.step_generator(0))
    with plain_versions():
        aux_p, g_p = t.loss_and_grads(params, db, t.step_generator(0))
    lk, lp = float(aux_k["nce_loss"]), float(aux_p["nce_loss"])
    nk, npl = (float(cuda_adam.sq_norms_reference(g.values())[2]) for g in (g_k, g_p))
    worst = max((float(torch.linalg.vector_norm(g_k[k] - g_p[k])
                       / torch.linalg.vector_norm(g_p[k]).clamp_min(1e-30)), k) for k in g_p)
    print(f"  {what}, kernel path vs plain path (f32): loss {lk:.6f} vs {lp:.6f} (rel "
          f"{_rel(lk, lp):.3e}, tol 1e-4), grad norm {nk:.6f} vs {npl:.6f} (rel "
          f"{_rel(nk, npl):.3e}, tol 1e-4), worst tensor |dg|/|g| {worst[0]:.3e} ({worst[1]}, "
          f"tol 1e-3), nce_acc {float(aux_k['nce_acc']):.4f} vs {float(aux_p['nce_acc']):.4f}",
          flush=True)
    check(math.isfinite(lk) and _rel(lk, lp) <= 1e-4, f"{what}: loss {lk} vs plain {lp}")
    check(math.isfinite(nk) and _rel(nk, npl) <= 1e-4, f"{what}: grad norm {nk} vs {npl}")
    check(worst[0] <= 1e-3, f"{what}: gradient of {worst[1]} off by {worst[0]:.3e}")
    return t, params, db


def _sets(pairs) -> list:
    return [a for kv in pairs for a in ("--set", kv)]


def phase_ssl(torch, np, root: str, launches: dict) -> None:
    """SSL pretraining and the feature-cache path on the card (after
    phase_frame_ce, in the same directory): K5 / K5-bwd at the context
    GRU's shape; configs/formant39_ssl.yaml at full width through the CLI
    with ``ssl.context_pallas=true`` on a formant corpus written by
    ``prepare synth`` (SSL_STEPS steps, each 1 K5, 1 K5-bwd chain and its
    coefficient kernel; the first step's kernel path against the plain
    path), SSL_SHORT steps with ``ssl.input_type=fbank`` (1 K1 more) and
    with ``ssl.fused_loss=true``; ``tools.featurize --cmvn --pca 512
    --pool-kmeans 128`` of the train split (and the dev split with
    ``--transforms-from``), ``prepare kmeans --feature-cache`` with 128
    clusters; configs/wav2vecu_pod_stretch.yaml's gan+eodm over the cache
    from the device-resident corpus (GAN_ALTS alternations), ``--mode
    infer`` from the cache and one self-training round over it."""
    from uasr_torch import cli, pretrain, train
    from uasr_torch.config import load_config
    from uasr_torch.data import cache as fcache
    from uasr_torch.data.loader import StreamingASRDataset
    from uasr_torch.tools import featurize, prepare
    from uasr_torch.tools import selftrain as st_tool
    from uasr_torch.vocab import load_vocab

    t_phase = time.perf_counter()
    ssl_kernels(torch, np)
    corpus = os.path.join(root, "formant")
    prepare_quiet(prepare, ["synth", "--out-dir", corpus, "--num-utts", str(SSL_UTTS),
                            "--num-phones", "39", "--syntax", "markov", "--style", "formant",
                            "--min-len", "20", "--max-len", "45"])
    recipe = os.path.join(REPO, "configs", "formant39_ssl.yaml")
    ssl_dir = os.path.join(root, "ssl")
    data = [f"data.train_list={corpus}/train.tsv", f"data.dev_list={corpus}/dev.tsv",
            f"data.vocab_path={corpus}/vocab.txt", "data.synthetic=false",
            "ssl.context_pallas=true", "train.log_every=1", "train.eval_every=1000000"]
    want = {"K5": 1, "K5-bwd": 1, "K5-bwd:coeffs": 1, "K-adam": 2}
    print(f"ssl: formant39_ssl (patch 20, conv 256/256/512, context GRU 512 through K5, K=8, "
          f"100 negatives, B=16 x 6 s, f32) on a {SSL_UTTS}-utterance formant corpus; card "
          f"{card_line()}", flush=True)
    for tag, extra, steps, more in (("waveform", [], SSL_STEPS, {}),
                                    ("fbank", ["ssl.input_type=fbank"], SSL_SHORT, {"K1": 1}),
                                    ("fused", ["ssl.fused_loss=true"], SSL_SHORT, {})):
        model_dir = ssl_dir if tag == "waveform" else os.path.join(root, f"ssl_{tag}")
        sets = [*data, *extra, f"model_dir={model_dir}", f"train.total_steps={steps}",
                f"train.save_every={steps}"]
        record: dict = {}
        reset_launches()
        t0 = time.perf_counter()
        with traced_methods(torch, [(pretrain.SSLTrainer, "train_step")], record):
            run_cli(torch, ["-c", recipe, "--mode", "train", *_sets(sets)])
        wall = time.perf_counter() - t0
        counts = read_launches()
        with open(os.path.join(model_dir, "metrics.jsonl")) as f:
            recs = [json.loads(ln) for ln in f if '"train"' in ln]
        st = record["train_step"]
        check(len(st) == steps and len(recs) == steps, f"ssl {tag}: {len(st)} steps, "
              f"{len(recs)} logged")
        step_want = dict(want, **more)
        for i, (s_, r) in enumerate(zip(st, recs)):
            check(s_["launches"] == step_want, f"ssl {tag} step {i + 1}: launches "
                  f"{s_['launches']}, expected {step_want}")
            check(np.isfinite(r["nce_loss"]) and 0.0 <= r["nce_acc"] <= 1.0
                  and np.isfinite(r["grad_norm"]), f"ssl {tag} step {i + 1}: {r}")
        walls = [s_["wall"] for s_ in st]
        tail = walls[-10:] if tag == "waveform" else walls[1:]
        print(f"  {tag}: {steps} steps through the CLI in {wall:.2f} s (start-up included); "
              f"step wall median {np.median(tail) * 1e3:.2f} ms over steps "
              f"{steps - len(tail) + 1}-{steps} (min {min(tail) * 1e3:.2f}, max "
              f"{max(tail) * 1e3:.2f}; first {walls[0] * 1e3:.2f}); {16 * 6 / np.median(tail):.1f} "
              f"audio-s/s; nce_acc {recs[0]['nce_acc']:.4f} at step 1 -> "
              f"{recs[-1]['nce_acc']:.4f} at step {steps}, nce_loss {recs[0]['nce_loss']:.4f} "
              f"-> {recs[-1]['nce_loss']:.4f}; launches a step {step_want}", flush=True)
        for k in ("K1", "K5", "K5-bwd"):
            launches[k] = launches.get(k, 0) + counts[k]
        cfg = load_config(recipe)
        cli.apply_overrides(cfg, sets)
        source, _ = cli._load_source(cfg, "train")
        it = cli._batches(cfg, source, seed=cfg.train.seed)
        first = next(it)
        it.close()
        t, params, db = ssl_first_step(torch, cfg, first, f"ssl {tag} first step")
        if tag == "waveform":
            profile_call(torch, lambda: t.train_step(train.TrainState(0, params,
                                                                      t.optimizer.init(params)),
                                                     db), "one SSL step")

    # ---- featurize: the train split (fit PCA and the pooling k-means), then
    # the dev split through the train split's transforms
    feats, feats_dev = os.path.join(root, "w2v_train"), os.path.join(root, "w2v_dev")
    fsets = _sets([*data, f"model_dir={ssl_dir}"])
    vocab = load_vocab(f"{corpus}/vocab.txt")
    ds = StreamingASRDataset.from_file(f"{corpus}/train.tsv", vocab, 16000)
    raw = 0
    for n in ds.num_samples:
        n = -(-min(int(n), 96000) // 20)
        for s_ in (4, 2, 1):
            n = -(-n // s_)
        raw += n
    reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        featurize.main(["-c", recipe, *fsets, "--split", "train", "--out", feats, "--cmvn",
                        "--pca", "512", "--pool-kmeans", "128", "--sample-frames",
                        str(SSL_SAMPLE_FRAMES)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_launches()
    cache = fcache.FeatureCache(feats)
    pooled = sum(len(f) for _, f, _ in cache)
    nb = -(-len(ds) // 16)
    check(len(cache) == len(ds) and cache.dim == 512, f"featurize wrote {len(cache)} utts of "
          f"dim {cache.dim}")
    check(counts["K5"] == 2 * nb and counts["K5-bwd"] == 0, f"featurize launches {counts}")
    launches["K5"] += counts["K5"]
    print(f"  featurize --cmvn --pca 512 --pool-kmeans 128 (reservoir {SSL_SAMPLE_FRAMES}): "
          f"{len(cache)} utterances in {wall:.2f} s with the restore and both passes, "
          f"{len(cache) / wall:.1f} utt/s; {raw} frames -> {pooled} after pooling "
          f"({pooled / raw:.3f}); {counts['K5']} K5 launches ({nb} batches x 2 passes)",
          flush=True)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        featurize.main(["-c", recipe, *fsets, "--split", "dev", "--out", feats_dev, "--cmvn",
                        "--pca", "512", "--pool-kmeans", "128", "--transforms-from", feats])
    print(f"  featurize of the dev split through the train split's transforms: "
          f"{len(fcache.FeatureCache(feats_dev))} utterances in {time.perf_counter() - t0:.2f} s",
          flush=True)
    km = os.path.join(root, "kmeans128.npz")
    stretch = os.path.join(REPO, "configs", "wav2vecu_pod_stretch.yaml")
    t0 = time.perf_counter()
    prepare_quiet(prepare, ["kmeans", "--config", stretch, "--feature-cache", feats,
                            "--clusters", "128", "--max-utts", str(SSL_KMEANS_UTTS), "--out", km])
    print(f"  prepare kmeans --feature-cache, 128 clusters on {SSL_KMEANS_UTTS} utterances: "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    # ---- gan+eodm over the cache at wav2vecu_pod_stretch's widths
    w2v = os.path.join(root, "w2v")
    gsets = ["parallel.model_parallel=1", f"data.feature_cache={feats}",
             f"data.dev_feature_cache={feats_dev}", f"data.test_feature_cache={feats_dev}",
             f"gan.centroids_path={km}", f"data.vocab_path={corpus}/vocab.txt",
             "data.text_path=none", "train.log_every=1"]
    record, gathers = {}, []
    reset_launches()
    t0 = time.perf_counter()
    with traced_methods(torch, [(train.GANTrainer, "d_step"), (train.GANTrainer, "g_step")],
                        record), timed_gathers(torch, gathers):
        run_cli(torch, ["-c", stretch, "--mode", "train", *_sets(
            [*gsets, f"model_dir={w2v}", f"train.total_steps={GAN_ALTS}",
             f"train.save_every={GAN_ALTS}"])])
    wall = time.perf_counter() - t0
    counts = {k: v for k, v in read_launches().items() if v}
    corpus_info = dict(fcache.LAST_DEVICE_CORPUS)
    with open(os.path.join(w2v, "metrics.jsonl")) as f:
        recs = [json.loads(ln) for ln in f if '"train"' in ln]
    d, g = record["d_step"], record["g_step"]
    check(len(d) == len(g) == GAN_ALTS == len(recs), f"gan: {len(d)} d, {len(g)} g steps")
    check(all(np.isfinite(r["d_loss"]) and np.isfinite(r["eodm_loss"]) for r in recs),
          f"gan: non-finite losses {recs[-1]}")
    check(not counts.get("K1"), f"gan over the cache ran the frontend: {counts}")
    alt = [a["wall"] + b["wall"] for a, b in zip(d, g)]
    # one batch's row gather alone on the card, at the corpus's shape
    rows = torch.zeros(corpus_info["shape"], device=torch.device(DEVICE))
    idx = torch.randperm(rows.shape[0], device=rows.device)[:256]
    g_ms = cuda_ms(torch, lambda: rows.index_select(0, idx), 20)
    g_bound = bound(2 * 256 * rows[0].numel() * 4, 0, "float32")[0]
    del rows
    print(f"  gan+eodm over the cache (classifier 1024 x 3, critic 512 x 4, bf16, B=256, "
          f"max_frames 800, kmeans-128 segmentation): {GAN_ALTS} alternations through the CLI "
          f"in {wall:.2f} s (start-up included); alternation wall median "
          f"{np.median(alt[1:]) * 1e3:.2f} ms (first {alt[0] * 1e3:.2f}; critic step "
          f"{np.median([a['wall'] for a in d[1:]]) * 1e3:.2f}, generator step "
          f"{np.median([b['wall'] for b in g[1:]]) * 1e3:.2f}); device corpus "
          f"{corpus_info['shape']} {corpus_info['bytes'] / 1e6:.1f} MB uploaded in "
          f"{corpus_info['upload_s'] * 1e3:.1f} ms; {len(gathers)} batches: the first (corpus "
          f"build from the cache and upload) {gathers[0] * 1e3:.1f} ms on the host, then "
          f"median {np.median(gathers[1:]) * 1e3:.3f} ms to issue (max "
          f"{max(gathers[1:]) * 1e3:.3f}); a B=256 gather on the card {g_ms:.4f} ms (bound "
          f"{g_bound:.4f}, bytes); "
          f"d_loss {recs[-1]['d_loss']:.4f} eodm_loss {recs[-1]['eodm_loss']:.4f}; launches "
          f"{counts}", flush=True)
    # one alternation profiled, from a fresh trainer on the same device corpus
    from uasr_torch.data.dataset import text_batch_iterator
    from uasr_torch.ops.eodm import device_ngram_tables

    gcfg = load_config(stretch)
    cli.apply_overrides(gcfg, [*gsets, f"model_dir={w2v}"])
    source, gvocab = cli._load_source(gcfg, "train")
    gcfg = gcfg.replace(vocab_size=len(gvocab))
    text = cli._load_text(gcfg, source, gvocab)
    dev = torch.device(DEVICE)
    it = cli._batches(gcfg, source, seed=gcfg.train.seed, device=dev)
    gt = train.GANTrainer(gcfg, device=dev, tables=device_ngram_tables(gcfg.eodm, text, dev))
    gstate = [gt.init_state()]
    text_it = text_batch_iterator(text, gcfg.data.batch_size, gcfg.data.max_label_len, seed=0)

    def alternation_step():
        gstate[0], _ = gt.d_step(gstate[0], next(it), next(text_it))
        gstate[0], _ = gt.g_step(gstate[0], next(it))

    alternation_step()
    alternation_step()
    profile_call(torch, alternation_step, "one gan+eodm alternation over the cache (B=256)")
    it.close()
    t0 = time.perf_counter()
    out = run_cli(torch, ["-c", stretch, "--mode", "infer",
                          *_sets([*gsets, f"model_dir={w2v}"])])
    check(out.startswith(f"step {GAN_ALTS}: PER="), f"infer printed {out!r}")
    print(f"  --mode infer from the dev cache (greedy; ctc.use_beam is off in the recipe): "
          f"{out.strip()} in {time.perf_counter() - t0:.2f} s", flush=True)
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = st_tool.main(["-c", stretch, *_sets([*gsets, f"model_dir={root}/w2v_st"]),
                           "--teacher-dir", w2v, "--teacher-mode", "gan", "--student-steps",
                           str(W2V_SELF_STEPS)])
    torch.cuda.synchronize()
    lines = buf.getvalue().strip().splitlines()
    check(rc == 0 and lines and lines[-1].startswith("teacher PER="), f"selftrain: {lines[-3:]}")
    print(f"  self-training round over the cache ({W2V_SELF_STEPS} student steps from the "
          f"device-resident student corpus): {lines[-1]} in {time.perf_counter() - t0:.2f} s",
          flush=True)
    print(f"  ssl phase: {time.perf_counter() - t_phase:.1f} s", flush=True)


PIPE_SEEDS = 2  # seeds of the pipeline's sweep


def phase_pipeline(torch, np, root: str, launches: dict) -> str:
    """The one-command unsupervised pipeline on the card (after phase_ssl,
    in the same directory): ``tools.pipeline.main`` over phase_ssl's formant
    corpus, its ``ssl`` stage pointed at phase_ssl's checkpoint (it resumes
    at its last step and falls through), featurize ``--cmvn --pca 512`` of
    the train and dev splits, the bigram LM, PIPE_SEEDS seeds of
    wav2vecu_pod_stretch's gan+eodm over the cache (GAN_ALTS alternations,
    phase_ssl's 128 centroids, label-free selection) and one
    self-training round from the winner. Returns the workdir."""
    from uasr_torch.tools import pipeline

    t_phase = time.perf_counter()
    corpus = os.path.join(root, "formant")
    wd = os.path.join(root, "pipe")
    os.makedirs(wd)
    os.symlink(os.path.join(root, "ssl"), os.path.join(wd, "ssl"))
    ssl_sets = [f"data.train_list={corpus}/train.tsv", f"data.dev_list={corpus}/dev.tsv",
                f"data.vocab_path={corpus}/vocab.txt", "data.synthetic=false",
                "ssl.context_pallas=true", "train.log_every=1", "train.eval_every=1000000",
                f"train.total_steps={SSL_STEPS}", f"train.save_every={SSL_STEPS}"]
    unsup_sets = ["parallel.model_parallel=1", f"gan.centroids_path={root}/kmeans128.npz",
                  f"data.vocab_path={corpus}/vocab.txt", "data.text_path=none",
                  "train.log_every=1", f"train.total_steps={GAN_ALTS}",
                  f"train.save_every={GAN_ALTS}", f"train.eval_every={GAN_ALTS}"]
    argv = ["--workdir", wd, "--ssl-config", os.path.join(REPO, "configs", "formant39_ssl.yaml"),
            "--unsup-config", os.path.join(REPO, "configs", "wav2vecu_pod_stretch.yaml"),
            "--seeds", str(PIPE_SEEDS), "--cmvn", "--pca", "512", "--selftrain-rounds", "1",
            "--student-steps", str(W2V_SELF_STEPS),
            *[a for kv in ssl_sets for a in ("--set-ssl", kv)],
            *[a for kv in unsup_sets for a in ("--set-unsup", kv)]]
    reset_launches()
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = pipeline.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: v for k, v in read_launches().items() if v}
    with open(os.path.join(wd, "report.json")) as f:
        report = json.load(f)
    last = json.loads(buf.getvalue().strip().splitlines()[-1])
    stages = report["stages"]
    check(rc == 0 and set(stages) == {"ssl", "featurize", "lm", "sweep", "selftrain"},
          f"pipeline: rc {rc}, stages {sorted(stages)}")
    check(last["final_model"] == report["final_model"], f"pipeline: last line {last}")
    check(all(os.path.exists(os.path.join(wd, f"export_{r}.yaml")) for r in ("winner", "student")),
          "pipeline: export recipes missing")
    t, st = report["teacher_per"], report["student_per"]
    check(t is not None and st is not None and math.isfinite(t) and math.isfinite(st),
          f"pipeline: PERs {t}, {st}")
    feat = stages["featurize"]
    check(counts.get("K5", 0) > 0 and not counts.get("K1"), f"pipeline launches {counts}")
    launches["K5"] += counts["K5"]
    ranking = ", ".join(f"seed {r['seed']} {r['score']:.4f}"
                        for r in stages["sweep"]["ranking"])
    print(f"pipeline: formant39_ssl (phase_ssl's step-{SSL_STEPS} checkpoint) -> featurize "
          f"--cmvn --pca 512 ({feat['train_utts']} + {feat['dev_utts']} utterances) -> bigram "
          f"LM -> {PIPE_SEEDS} seeds x {GAN_ALTS} gan+eodm alternations of wav2vecu_pod_stretch "
          f"(label-free scores {ranking}) -> one self-training round ({W2V_SELF_STEPS} student "
          f"steps): {wall:.1f} s; stage seconds "
          f"{ {k: v['seconds'] for k, v in stages.items()} }; winner seed "
          f"{report['winner']['seed']}; teacher dev PER {t:.4f}, student dev PER {st:.4f}; "
          f"final model {os.path.relpath(report['final_model'], wd)}; launches {counts}; card "
          f"{card_line()}", flush=True)
    print(f"  pipeline phase: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return wd


def seeded_checkpoint(torch, recipe: str, sets: list, model_dir: str) -> None:
    """A step-0 checkpoint of the recipe's CTC model with the seeded
    weights its trainer draws."""
    from uasr_torch import cli
    from uasr_torch.checkpoint import CheckpointManager
    from uasr_torch.config import load_config
    from uasr_torch.train import CTCTrainer

    cfg = load_config(recipe)
    cli.apply_overrides(cfg, sets)
    CheckpointManager(os.path.join(model_dir, "ckpt")).save(
        0, CTCTrainer(cfg, device=torch.device(DEVICE)).init_state())


def program_inputs(torch, np, name: str, built, seed: int):
    """Seeded inputs of an exported program: audio of random lengths for an
    offline program, a random chunk from the initial state for ``step``,
    the state after that chunk for ``finish``."""
    rng = np.random.RandomState(seed)
    if name == "model":
        example = built.programs["model"][1]
        B, L = example[0].shape
        lens = np.maximum((L * rng.uniform(0.6, 1.0, B)).astype(np.int32), 1)
        lens[0] = L
        audio = (0.1 * rng.randn(B, L)).astype(np.float32)
        audio[np.arange(L)[None, :] >= lens[:, None]] = 0.0
        dev = example[0].device
        return (torch.tensor(audio, device=dev), torch.tensor(lens, device=dev))
    step, (state0, chunk0) = built.programs["step"]
    chunk = torch.tensor((0.1 * rng.randn(*chunk0.shape)).astype(np.float32),
                         device=chunk0.device)
    if name == "step":
        return (state0, chunk)
    with torch.no_grad():
        return (step(state0, chunk)[0],)


def export_case(torch, np, what: str, argv: list, want: dict, reps: int = 5) -> dict:
    """``tools.export.main`` with ``--check`` on the card (the reloaded
    programs bit-equal to the live forward on random audio), then each
    reloaded program against the live one rebuilt from the same checkpoint
    on seeded inputs: bit-equal outputs, its launches in one call equal to
    ``want[name]``, its size and call time beside the live forward's."""
    from uasr_torch.tools import export

    out = argv[argv.index("--out") + 1]
    argv = [*argv, "--device", DEVICE]
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = export.main([*argv, "--check"])
    torch.cuda.synchronize()
    t_export = time.perf_counter() - t0
    check(rc == 0, f"export {what}: exit {rc}")
    with open(os.path.join(out, "meta.json")) as f:
        meta = json.load(f)
    built = export.build_programs(export.parse_args(argv))
    sizes = {}
    for name, (prog_live, _) in built.programs.items():
        path = os.path.join(out, f"{name}.pt2")
        prog = torch.export.load(path).module()
        args = program_inputs(torch, np, name, built, SEED + 31)
        with torch.no_grad():
            want_out = prog_live(*args)
            torch.cuda.synchronize()
            reset_launches()
            got = prog(*args)
            torch.cuda.synchronize()
            counts = {k: v for k, v in read_launches().items() if v}
            export.outputs_equal(got, want_out)
            ms = cuda_ms(torch, lambda: prog(*args), reps)
            live_ms = cuda_ms(torch, lambda: prog_live(*args), reps)
        check(counts == want[name], f"export {what} {name}: launches {counts}, expected "
              f"{want[name]}")
        sizes[name] = os.path.getsize(path)
        print(f"  export {what} [{name}.pt2]: {sizes[name] / 1e6:.2f} MB, operators "
              f"{sorted(set(meta['operators'][name]))}; reloaded program bit-equal to the live "
              f"forward; launches a call {counts}; call {ms:.3f} ms against the live "
              f"forward's {live_ms:.3f} ms (CUDA events, {reps} calls)", flush=True)
    print(f"  export {what}: main with --check {t_export:.1f} s; quantization "
          f"{meta['quantization']}", flush=True)
    return dict(sizes=sizes, out=out, built=built)


def fresh_process_run(torch, np, out: str, built) -> None:
    """Reload the offline program in a new ``python3 -c`` process that
    imports only torch and uasr_torch.ops.library, run it there on seeded
    inputs, and hold its outputs bit-equal to the live forward's."""
    from uasr_torch.tools import export

    prog_live = built.programs["model"][0]
    args = program_inputs(torch, np, "model", built, SEED + 32)
    inp, res = os.path.join(out, "inputs.pt"), os.path.join(out, "outputs.pt")
    torch.save(args, inp)
    code = (
        "import sys, time, torch, uasr_torch.ops.library as L\n"
        f"prog = torch.export.load({os.path.join(out, 'model.pt2')!r}).module()\n"
        f"args = torch.load({inp!r})\n"
        "t0 = time.perf_counter(); out = prog(*args); torch.cuda.synchronize()\n"
        "wall = time.perf_counter() - t0\n"
        f"torch.save(out, {res!r})\n"
        "mods = sorted(m for m in sys.modules if m.split('.')[0] in ('uasr', 'jax'))\n"
        "print(f'first call {wall:.2f} s (the kernels load at their first launch); launches '"
        "f'K1 {L.cf.LAUNCHES} K2 {L.cg.LAUNCHES} K4 {L.cb.LAUNCHES}; jax or uasr modules {mods}')\n"
    )
    t0 = time.perf_counter()
    proc = subprocess.run(["python3", "-c", code], cwd=REPO, capture_output=True, text=True,
                          timeout=600)
    check(proc.returncode == 0, f"fresh process: {proc.stderr[-2000:]}")
    with torch.no_grad():
        export.outputs_equal(torch.load(res), prog_live(*args))
    print(f"  fresh process (imports torch and uasr_torch.ops.library only): "
          f"{proc.stdout.strip()}; {time.perf_counter() - t0:.1f} s with start-up; outputs "
          f"bit-equal to the live forward", flush=True)


def phase_export(torch, np, root: str, wd: str) -> None:
    """The serving export on the card at full width (after phase_pipeline,
    in the same directory): ``tools.export`` of phase_data's
    librispeech_ctc_bigru checkpoint (offline, beam 16, B = 32 x 16 s: 1 K1,
    3 K2, 1 K4 a call), of the pipeline's winner through
    ``--compose-from-pipeline`` (the SSL featurizer's context through K5,
    CMVN, PCA, the classifier with k-means segmentation; B = 16 x 6 s), of
    configs/aishell_streaming.yaml's cnn ``--streaming`` (64 streams, beam 8
    over V = 4233: 1 K7 and 1 K4 a step) in f32 and with ``--quantize
    int8-compute``, and of a conformer on librispeech_ctc_bigru's widths
    (1 K1, 4 K6, 1 K4 a call), seeded weights where no phase trained them;
    each reloaded and held to the live forward, and the librispeech program
    run in a fresh process."""
    t_phase = time.perf_counter()
    print(f"export: torch.export programs on the card {card_line()}", flush=True)
    libri = os.path.join(REPO, "configs", "librispeech_ctc_bigru.yaml")
    chars = ["--set", f"data.vocab_path={root}/chars.txt"]
    res = export_case(torch, np, "librispeech_ctc_bigru beam", [
        "-c", libri, "--out", os.path.join(root, "exp_libri"), "--batch", str(K1_B),
        "--seconds", str(K1_SECONDS), *chars, "--set", f"model_dir={root}/libri"],
        {"model": {"K1": 1, "K2": 3, "K4": 1}})
    fresh_process_run(torch, np, res["out"], res["built"])
    export_case(torch, np, "pipeline winner (composed featurizer)", [
        "-c", os.path.join(wd, "export_winner.yaml"), "--compose-from-pipeline", wd, "--out",
        os.path.join(root, "exp_winner"), "--batch", "16", "--seconds", "6"],
        {"model": {"K5": 1}})
    aishell = os.path.join(REPO, "configs", "aishell_streaming.yaml")
    a_sets = ["vocab_size=4233", f"model_dir={root}/aishell"]
    seeded_checkpoint(torch, aishell, a_sets, os.path.join(root, "aishell"))
    stream = ["-c", aishell, "--streaming", "--batch", str(STREAM_B), *_sets(a_sets)]
    want = {"step": {"K7": 1, "K4": 1}, "finish": {"K4": 1}}
    f32 = export_case(torch, np, "aishell_streaming --streaming",
                      [*stream, "--out", os.path.join(root, "exp_stream")], want)
    q8 = export_case(torch, np, "aishell_streaming --streaming --quantize int8-compute",
                     [*stream, "--out", os.path.join(root, "exp_stream_q8"), "--quantize",
                      "int8-compute"], want)
    print(f"  step.pt2 f32 {f32['sizes']['step'] / 1e6:.2f} MB against int8 "
          f"{q8['sizes']['step'] / 1e6:.2f} MB", flush=True)
    c_sets = ["model.encoder=conformer", "model.attn_pallas=true", "vocab_size=32",
              f"model_dir={root}/conformer"]
    seeded_checkpoint(torch, libri, c_sets, os.path.join(root, "conformer"))
    export_case(torch, np, "conformer beam", [
        "-c", libri, "--out", os.path.join(root, "exp_conformer"), "--batch", str(K1_B),
        "--seconds", str(K1_SECONDS), *_sets(c_sets)], {"model": {"K1": 1, "K6": 4, "K4": 1}})
    print(f"  export phase: {time.perf_counter() - t_phase:.1f} s", flush=True)


DIST_TIMEOUT = 420  # join timeout of each rank group (seconds)
DIST_B, DIST_SECONDS = 32, 8.0  # librispeech's 8 s bucket at the recipe's batch
TP_B, TP_SECONDS = 8, 8.0  # the tensor-parallel transformer step's batch


def dist_config():
    """librispeech_ctc_bigru at full width with SpecAugment off: a step
    whose batch is split must draw nothing, so that it is the step of the
    whole batch (the CPU tests hold the split draws)."""
    cfg = recipe_config(len(char_vocab()))
    return cfg.replace(frontend=dataclasses.replace(cfg.frontend, specaug_freq_masks=0,
                                                    specaug_time_masks=0))


def tp_config(seq: bool, m: int):
    """attention_config's transformer (d = 512, 8 heads of 64, 4 blocks,
    bf16, attn_pallas) on ``model_parallel: m``, SpecAugment off."""
    cfg = attention_config("transformer", len(char_vocab()))
    return cfg.replace(frontend=dataclasses.replace(cfg.frontend, specaug_freq_masks=0,
                                                    specaug_time_masks=0),
                       model=dataclasses.replace(cfg.model, sequence_shard=seq),
                       parallel=dataclasses.replace(cfg.parallel, model_parallel=m))


def compare_moments(torch, what: str, mu: dict, ref_mu: dict, loss: float, ref_loss: float,
                    norm: float, ref_norm: float, floor: float = 0.0) -> None:
    """One step's first Adam moments (0.1 x the clipped gradient) against
    the one-process step's, at compare_first_step's bf16 bars: loss 1e-3,
    grad norm 1e-2, worst tensor 5e-2 of its norm (or of ``floor`` x the
    largest tensor norm, for the rounding-floor key biases)."""
    top = max(float(torch.linalg.vector_norm(v.float())) for v in ref_mu.values())
    worst = max((float(torch.linalg.vector_norm(mu[k].float() - ref_mu[k].float())
                       / torch.linalg.vector_norm(ref_mu[k].float()).clamp_min(
                           max(floor * top, 1e-30))), k) for k in ref_mu)
    print(f"  {what}: loss {loss:.6f} vs {ref_loss:.6f} (rel {_rel(loss, ref_loss):.3e}, tol "
          f"1e-3), grad norm {norm:.6f} vs {ref_norm:.6f} (rel {_rel(norm, ref_norm):.3e}, "
          f"tol 1e-2), worst moment |d|/|m| {worst[0]:.3e} ({worst[1]}, tol 5e-2)", flush=True)
    check(set(mu) == set(ref_mu), f"{what}: leaves {sorted(set(mu) ^ set(ref_mu))[:4]}")
    check(math.isfinite(loss) and _rel(loss, ref_loss) <= 1e-3, f"{what}: loss {loss}")
    check(_rel(norm, ref_norm) <= 1e-2, f"{what}: grad norm {norm} vs {ref_norm}")
    check(worst[0] <= 5e-2, f"{what}: moment of {worst[1]} off by {worst[0]:.3e}")


def ids_equal(hyps, lens, ref_hyps, ref_lens) -> bool:
    """The same lengths and, within them, the same ids."""
    lens, ref_lens = lens.long(), ref_lens.long()
    return lens.shape == ref_lens.shape and bool((lens == ref_lens).all()) and all(
        bool((hyps[i, : int(n)].long() == ref_hyps[i, : int(n)].long()).all())
        for i, n in enumerate(ref_lens))


def _cpu(d: dict) -> dict:
    return {k: v.detach().float().cpu().clone() for k, v in d.items()}


@contextlib.contextmanager
def timed_collectives(torch, record: dict):
    """Wall seconds and calls of every ``all_reduce`` / ``all_gather`` the
    port issues inside (synchronised before and after, so each is charged
    its own time), by kind, into ``record``."""
    import torch.distributed as dist

    saved = {n: getattr(dist, n) for n in ("all_reduce", "all_gather")}
    sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)

    def wrap(name, fn):
        def timed(*a, **k):
            sync()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            sync()
            record[name] = record.get(name, 0.0) + time.perf_counter() - t0
            record[f"{name} calls"] = record.get(f"{name} calls", 0) + 1
            return out
        return timed

    for n, fn in saved.items():
        setattr(dist, n, wrap(n, fn))
    try:
        yield record
    finally:
        for n, fn in saved.items():
            setattr(dist, n, fn)


def timed_step(torch, step) -> tuple:
    """(wall s, collectives' record) of ``step()``, which ends in a
    synchronise."""
    rec: dict = {}
    sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)
    sync()
    t0 = time.perf_counter()
    with timed_collectives(torch, rec):
        step()
        sync()
    return time.perf_counter() - t0, rec


def collective_line(wall: float, rec: dict) -> str:
    coll = sum(v for k, v in rec.items() if not k.endswith("calls"))
    parts = ", ".join(f"{k} {rec[k] * 1e3:.2f} ms x{rec[k + ' calls']}"
                      for k in ("all_reduce", "all_gather") if k in rec)
    return (f"wall {wall * 1e3:.2f} ms, collectives {coll * 1e3:.2f} ms "
            f"({coll / wall:.1%}; {parts or 'none'})")


def dist_rank_main(spec_path: str, out_path: str) -> int:
    """One rank of phase_distributed's two-rank group on cuda:0 over gloo:
    the data-parallel librispeech step on mesh (2, 1), the transformer
    step with sequence_shard on mesh (1, 2) (K6's heads per launch
    recorded), and the beam-16 decode split over mesh (2, 1) (this rank's
    ids and the gathered ids recorded); writes its results to
    ``out_path.rank<r>``."""
    import numpy as np
    import torch

    sys.path.insert(0, REPO)
    from uasr_torch import infer, train
    from uasr_torch.frontend.features import make_frontend_state
    from uasr_torch.ops import cuda_attention
    from uasr_torch.parallel import init_distributed, local_device, make_mesh, shard_batch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = torch.load(spec_path, weights_only=False)
    init_distributed(spec["device"], backend="gloo")
    dev = local_device(spec["device"])
    meshes = {m: make_mesh(m, dev.type) for m in (1, 2)}
    out: dict = {}

    cfg = spec["dp_cfg"]
    tr = train.CTCTrainer(cfg, device=dev, mesh=meshes[1])
    tr.model.load_state_dict(spec["dp_weights"])
    reset_launches()
    rows = shard_batch(spec["dp_batch"], meshes[1])
    state, aux = tr.train_step(tr.init_state(), rows)
    out["dp"] = dict(launches=read_launches(), loss=float(aux["loss"]),
                     grad_norm=float(aux["grad_norm"]), mu=_cpu(state.opt_state["mu"]))
    out["dp"]["timed"] = timed_step(torch, lambda: tr.train_step(state, rows))

    heads: list = []
    fwd = cuda_attention.mhsa_fwd_cuda

    def recorded(q, k, v, bias, kmask, num_heads):
        heads.append(num_heads)
        return fwd(q, k, v, bias, kmask, num_heads)

    cuda_attention.mhsa_fwd_cuda = recorded
    tp = train.CTCTrainer(spec["tp_cfg"], device=dev, mesh=meshes[2])
    tp.model.load_state_dict(tp.plans[0].shard(spec["tp_weights"]))
    reset_launches()
    state, aux = tp.train_step(tp.init_state(), spec["tp_batch"])
    out["tp"] = dict(launches=read_launches(), heads=list(heads), loss=float(aux["loss"]),
                     grad_norm=float(aux["grad_norm"]),
                     mu=_cpu(tp.plans[0].gather(state.opt_state["mu"])))
    cuda_attention.mhsa_fwd_cuda = fwd
    out["tp"]["timed"] = timed_step(torch, lambda: tp.train_step(state, spec["tp_batch"]))

    own, gathered = [], []
    decode, gather_hyps = infer._decode_batch, infer._gather_hyps

    def rec_decode(*a, **k):
        r = decode(*a, **k)
        own.append((r[0].cpu(), r[1].cpu()))
        return r

    def rec_gather(*a, **k):
        r = gather_hyps(*a, **k)
        gathered.append((r[0].cpu(), r[1].cpu()))
        return r

    infer._decode_batch, infer._gather_hyps = rec_decode, rec_gather
    model = tr.model
    model.load_state_dict(spec["dp_weights"])
    reset_launches()
    res = infer.run_inference(cfg, model, make_frontend_state(cfg.frontend, device=dev),
                              [spec["dp_batch"]], device=dev, mesh=meshes[1])
    out["decode"] = dict(launches=read_launches(), own=own, gathered=gathered,
                         impl=infer.LAST_BEAM_IMPL, errors=res["errors"],
                         ref_tokens=res["ref_tokens"])
    torch.save(out, f"{out_path}.rank{torch.distributed.get_rank()}")
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    return 0


def phase_distributed(torch, np, root: str, launches: dict) -> None:
    """Distribution and scale on the one card: ``train.grad_accum`` on a
    one-rank NCCL group, a two-rank gloo group on cuda:0 (the data-parallel
    librispeech step, the transformer with sequence_shard on two model
    ranks, the split beam decode) against one process, and the multichip
    dry run on four ranks. NCCL refuses two ranks on one device, so the
    multi-rank paths run over gloo here: every collective crosses the
    host, and no time of theirs is a multi-card figure."""
    import torch.distributed as dist

    from uasr_torch import infer, train
    from uasr_torch.frontend.features import make_frontend_state
    from uasr_torch.parallel import make_mesh
    from uasr_torch.parallel.launch import free_port, launch
    from uasr_torch.tools import dryrun_multichip

    dev = torch.device(DEVICE)
    t_phase = time.perf_counter()
    cfg = dist_config()
    batch = make_request(np, np.random.RandomState(SEED + 22), cfg, DIST_B, DIST_SECONDS)
    halves = [type(batch)(*(x[:DIST_B // 2] for x in batch)),
              type(batch)(*(x[DIST_B // 2:] for x in batch))]

    # 1. one-rank NCCL group: grad_accum 2 over two halves against one step
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()))
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index or 0)
    dist.init_process_group(backend, init_method="env://", world_size=1, rank=0)
    try:
        mesh = make_mesh(1, dev.type)
        probe = torch.ones(4, device=dev)
        dist.all_reduce(probe, group=mesh.data_group)
        check(bool((probe == 1).all()), f"NCCL all-reduce at world size 1: {probe}")
        one = train.CTCTrainer(cfg, device=dev)
        weights = {k: v.detach().clone() for k, v in one.model.state_dict().items()}
        reset_launches()
        s1, a1 = one.train_step(one.init_state(), batch)
        c1 = read_launches()
        acc = train.CTCTrainer(cfg.replace(train=dataclasses.replace(cfg.train, grad_accum=2)),
                               device=dev, mesh=mesh)
        acc.model.load_state_dict(weights)
        # the norm of the gradient the clip sees: the accumulated mean's
        clip_norms, inner = [], acc.optimizer._update

        def recorded(grads, opt_state, params):
            out = inner(grads, opt_state, params)
            clip_norms.append(float(out[1]))
            return out

        acc.optimizer._update = recorded
        s2 = acc.init_state()
        reset_launches()
        auxes = []
        for h in halves:
            before = {k: v.detach().clone() for k, v in s2.params.items()}
            s2, a2 = acc.train_step(s2, h)
            auxes.append(a2)
        c2 = read_launches()
    finally:
        dist.destroy_process_group()
    print(f"distributed: {cfg.name} B={DIST_B} x {DIST_SECONDS} s, SpecAugment off; "
          f"{backend} group of 1, grad_accum 2 over two halves vs one step of the batch",
          flush=True)
    print(f"  launches one step {c1}; accumulated {c2}", flush=True)
    check(s2.step == 2 and s2.opt_state["count"] == 1, f"grad_accum: step {s2.step}")
    check(not any(torch.equal(before[k], s2.params[k]) for k in ("logits.weight",)),
          "grad_accum: the second call did not update")
    check(all(c2[k] == 2 * c1[k] and c1[k] > 0 for k in ("K2", "K2-bwd")),
          f"grad_accum: K2 / K2-bwd launches {c2} not twice {c1}")
    # one step: K-norm, K-adam; accumulating: K-norm of each call's gradient,
    # then of the mean, and K-adam
    check(c1["K-adam"] == 2 and c2["K-adam"] == 4,
          f"grad_accum: K-norm + K-adam launches {c2['K-adam']} (one step {c1['K-adam']})")
    mean_loss = (float(auxes[0]["loss"]) + float(auxes[1]["loss"])) / 2
    # the moments hold the clipped gradient and Adam's first step is about
    # lr x its sign, so only the norm before the clip shows the scale
    check(len(clip_norms) == 1, f"grad_accum: {len(clip_norms)} clips in two calls")
    compare_moments(torch, "grad_accum 2 vs one step (grad norm: the accumulated mean's "
                    "before the clip vs one step's)", s2.opt_state["mu"], s1.opt_state["mu"],
                    mean_loss, float(a1["loss"]), clip_norms[0], float(a1["grad_norm"]))
    # a first Adam step moves each entry by at most lr, so entries whose
    # gradient sign differs part by up to 2 lr, plus the f32 rounding of
    # the two additions
    lr = one.optimizer.schedule(0)
    dp_max = max(float((s2.params[k] - s1.params[k]).detach().abs().max()) for k in s1.params)
    tol = 2 * lr + 2 * torch.finfo(torch.float32).eps * max(
        float(v.abs().max()) for v in weights.values())
    print(f"  parameters after the update: max|d| {dp_max:.3e} (tol 2 lr + 2 ulp = {tol:.3e})",
          flush=True)
    check(dp_max <= tol, f"grad_accum params off by {dp_max}")

    # 2. two ranks on cuda:0 over gloo; the references in this process
    tcfg = tp_config(True, 2)
    tone = train.CTCTrainer(tp_config(False, 1), device=dev)
    tweights = {k: v.detach().clone().cpu() for k, v in tone.model.state_dict().items()}
    tbatch = make_request(np, np.random.RandomState(SEED + 23), tcfg, TP_B, TP_SECONDS)
    spec = dict(device=dev.type, dp_cfg=cfg, dp_weights={k: v.cpu() for k, v in weights.items()}, dp_batch=batch,
                tp_cfg=tcfg, tp_weights=tweights, tp_batch=tbatch)
    spec_path, out_path = os.path.join(root, "dist_spec.pt"), os.path.join(root, "dist_out")
    torch.save(spec, spec_path)
    t0 = time.perf_counter()
    launch([os.path.join(REPO, "chip_smoke.py"), "--dist-rank", spec_path, out_path], 2,
           timeout=DIST_TIMEOUT, one_device=dev.type == "cuda", cwd=root)
    group_s = time.perf_counter() - t0
    ranks = [torch.load(f"{out_path}.rank{r}", weights_only=False) for r in range(2)]
    print(f"  two ranks on {dev} over gloo: {group_s:.1f} s for the group (start-up and "
          f"three cases)", flush=True)
    ts, ta = tone.train_step(tone.init_state(), tbatch)
    # the references' moments, before the timed second steps move them in place
    ref_dp, ref_tp = _cpu(s1.opt_state["mu"]), _cpu(ts.opt_state["mu"])
    one_dp = timed_step(torch, lambda: one.train_step(s1, batch))
    one_tp = timed_step(torch, lambda: tone.train_step(ts, tbatch))
    print(f"  second steps, gloo over one card's host path (not NCCL, not a multi-card "
          f"figure): one process, librispeech B={DIST_B}: {collective_line(*one_dp)}; "
          f"transformer B={TP_B}: {collective_line(*one_tp)}", flush=True)
    for r, res in enumerate(ranks):
        print(f"    rank {r}: data-parallel (2, 1) {collective_line(*res['dp']['timed'])}; "
              f"tensor/sequence-parallel (1, 2) {collective_line(*res['tp']['timed'])}",
              flush=True)
    want_dp = {"K1": 1, "K2": 3, "K2-bwd": 3, "K3": 1, "K3-bwd": 1, "K-adam": 2}
    for r, res in enumerate(ranks):
        d = res["dp"]
        print(f"  rank {r}, mesh (2, 1): librispeech step on its half, launches "
              f"{d['launches']}", flush=True)
        check(all(d["launches"][k] == n for k, n in want_dp.items()),
              f"rank {r} dp launches {d['launches']}")
        compare_moments(torch, f"rank {r} data-parallel step vs one process", d["mu"],
                        ref_dp, d["loss"], float(a1["loss"]),
                        d["grad_norm"], float(a1["grad_norm"]))
        t = res["tp"]
        L = tcfg.model.transformer_layers
        print(f"  rank {r}, mesh (1, 2): transformer step with sequence_shard, K6 heads per "
              f"launch {t['heads']}, launches {t['launches']}", flush=True)
        check(t["launches"]["K6"] == L and t["launches"]["K6-bwd"] == L
              and t["launches"]["K-adam"] == adam_launches(ts.params)
              and t["heads"] == [tcfg.model.num_heads // 2] * L,
              f"rank {r} tp launches {t['launches']} heads {t['heads']}")
        compare_moments(torch, f"rank {r} tensor/sequence-parallel transformer step vs one "
                        "process", t["mu"], ref_tp, t["loss"],
                        float(ta["loss"]), t["grad_norm"], float(ta["grad_norm"]), floor=1e-2)
    fstate = make_frontend_state(cfg.frontend, device=dev)
    one.model.load_state_dict(weights)  # the step above moved the module's own weights
    singles = []
    for h in halves:
        with torch.inference_mode():
            hy, hl, _, _ = infer._decode_batch(cfg, one.model.eval(), fstate,
                                               train._to_device(h, dev))
        singles.append((hy.cpu(), hl.cpu()))
    whole = (torch.cat([singles[0][0], singles[1][0]]), torch.cat([singles[0][1], singles[1][1]]))
    for r, res in enumerate(ranks):
        d = res["decode"]
        same = ids_equal(*d["own"][0], *singles[r])
        same_all = ids_equal(*d["gathered"][0], *whole)
        print(f"  rank {r}, mesh (2, 1): beam-16 decode of its half, ids bit-equal to one "
              f"process: {same}; gathered equal to the concatenation: {same_all}; "
              f"{d['impl']}, launches {d['launches']}", flush=True)
        check(same and same_all, f"rank {r}: split decode differs from one process")
        check(d["impl"] == "cuda_sharded" and d["launches"]["K4"] > 0
              and d["launches"]["K1"] > 0 and d["launches"]["K2"] == 3,
              f"rank {r} decode: {d['impl']} {d['launches']}")

    # 3. the dry run, four ranks on cuda:0
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        dryrun_multichip.main(["--ranks", "4", "--device", dev.type, "--backend", "gloo",
                               "--timeout", str(DIST_TIMEOUT)])
    line = buf.getvalue().strip().splitlines()[-1]
    res = json.loads(line.split("ok: ", 1)[1])
    print(f"  dry run, four ranks on {dev} (mesh (2, 2)) over gloo, "
          f"{time.perf_counter() - t0:.1f} s: {line}", flush=True)
    losses = [res[k] for k in ("ctc_loss", "d_loss", "g_loss", "eodm_loss",
                               "transformer_ctc_loss", "nce_loss")]
    check(all(math.isfinite(v) for v in losses), f"dry run losses {losses}")
    check(all(res["launches"][k] > 0 for k in ("K1", "K2", "K2-bwd", "K3", "K3-bwd", "K5",
                                               "K6", "K6-bwd")),
          f"dry run launches {res['launches']}")
    print(f"  phase_distributed: {time.perf_counter() - t_phase:.1f} s", flush=True)


def main() -> int:
    import numpy as np
    import torch

    if sys.argv[1:2] == ["--dist-rank"]:  # a rank of phase_distributed's group
        return dist_rank_main(*sys.argv[2:4])
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
    phase_adam_kernels(torch, np, results)
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
    phase_unsup(torch, np, launches)
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        phase_data(torch, np, tmp)
        phase_lm_decode(torch, np, tmp)
        phase_frame_ce(torch, np, tmp, launches)
        phase_ssl(torch, np, tmp, launches)
        wd = phase_pipeline(torch, np, tmp, launches)
        phase_export(torch, np, tmp, wd)
        phase_distributed(torch, np, tmp, launches)

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
        ("K-norm + K-adam, clip and Adam over every leaf (librispeech BiGRU's 22 leaves, f32)",
         "uasr_torch/csrc/clip_adam.cu", "none: XLA fuses optax's update (uasr/train.py:95)",
         "K-adam", "K-adam:bigru22"),
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
