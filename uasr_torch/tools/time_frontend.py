"""Time K1 and K7 (the log-mel frontend kernels) on the card, split them by
phase, and hold their outputs against a saved run:

  python -m uasr_torch.tools.time_frontend [--reps 20] [--save PATH] [--against PATH]
                                          [--tile RxWR ...]

The cases, inputs ``0.1 * randn`` from a fixed seed: (a) K1 at
``chip_smoke.py``'s shape, B = 32 x 16 s, ``FrontendConfig(num_mel_bins=80)``;
(b) K7 at the streaming chunk, B = 64, L = 240 + 64 x 160; (c) K7 at a
32-frame chunk, L = 240 + 32 x 160; then small cases for bit-equality:
K1 at L = 300, 400, 561 and 5000 (B = 3, 40 mel bins, as the card tests),
each with and without the log-energy column, (a) and (b) with it, K7 on
input shorter than one frame, and K1 and K7 at 50 ms frames with n_fft 1024
(FL = 800), which older kernels refuse.

Each case runs in all three tiers and prints one JSON line: the kernel's
time (CUDA events, the mean of ``--reps`` launches after one), the plain
version's, the bound in ``chip_smoke.py``'s terms (bytes over 3.35 TB/s or
operations over the type's peak, the mel product counted over the
filterbank's nonzero entries), max |d| against the plain version and the
number of elements that differ from it, and the launch plan. Where the
checkout has the stamped builds (``log_mel_fused_phases``,
``log_mel_unfused_phases``: thread 0's clock64 per phase; the compiler
moves arithmetic across stamps, so shares are approximate) it adds each
phase's share. ``--save`` writes every output; ``--against`` counts, per
case and tier, the elements that differ from a saved run.
``--tile 8x2 --tile 8x1 ...`` times each given tile (R frames a thread x
WR warp rows; kernels that take one).

It calls only ``log_mel_fused_cuda``, ``log_mel_unfused_cuda`` and the
plain versions otherwise, so the same file copied into an older checkout
times and saves that checkout's kernels.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

SEED = 0
TIERS = (("highest", 1e-4, 1, "float32"), ("high", 5e-4, 3, "bfloat16"),
         ("bfloat16", 2e-2, 1, "bfloat16"))
PEAK_BYTES = 3.35e12
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12}
# (name, fused, B, L, FrontendConfig overrides, want_energy)
MAIN = [("a:k1_b32x16s", True, 32, 16 * 16000, {}, False),
        ("b:k7_b64x64", False, 64, 240 + 64 * 160, {}, False),
        ("c:k7_b64x32", False, 64, 240 + 32 * 160, {}, False)]
SMALL = ([(f"k1_L{L}{'_energy' * e}", True, 3, L, {"num_mel_bins": 40}, e)
          for L in (300, 400, 561, 5000) for e in (False, True)]
         + [("a:k1_b32x16s_energy", True, 32, 16 * 16000, {}, True),
            ("b:k7_b64x64_energy", False, 64, 240 + 64 * 160, {}, True),
            ("k7_L300_energy", False, 3, 300, {}, True),
            ("k1_nfft1024", True, 4, 3 * 16000, {"frame_length_ms": 50.0, "n_fft": 1024}, True),
            ("k7_nfft1024", False, 8, 640 + 64 * 160, {"frame_length_ms": 50.0, "n_fft": 1024},
             False)])


def _timer(torch, reps: int):
    def ms(fn):
        fn()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps

    return ms


def bound(fused: bool, B: int, L: int, T: int, FL: int, NB: int, M: int, nnz: int,
          want_energy: bool, products: int, dtype: str) -> tuple[float, str]:
    """Least time (ms): each input read once and each output written once
    over the memory rate, or the operations over the type's peak rate."""
    consts = 2 * FL * NB + (2 * NB if fused else FL) + NB * M
    nbytes = 4 * (B * L + consts + B * T * (M + int(want_energy)))
    ops = (0 if fused else B * T * FL) + products * (2 * B * T * FL * 2 * NB + 2 * B * T * nnz)
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _plan(k, B, T, NB, precision):
    """The wrapper's launch plan, or the fixed one of kernels without one
    (32 frames a CTA, 8 for "high"; one thread a bin)."""
    plan = getattr(k, "LAST_PLAN", None)
    if plan is not None:
        return dict(plan)
    ft = 8 if precision == "high" else 32
    return dict(frames_per_cta=ft, threads=(NB + 31) // 32 * 32, ctas=B * -(-T // ft))


def _ndiff(torch, a, b) -> int:
    return int(((a != b) & ~(torch.isnan(a) & torch.isnan(b))).sum())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--save", help="write every output to this file (torch.save)")
    ap.add_argument("--against", help="count the elements differing from this saved run")
    ap.add_argument("--tile", action="append",
                    help="tile RxWR to time (repeatable; kernels that take one)")
    ap.add_argument("--only", action="append", help="run only cases whose name has this")
    args = ap.parse_args(argv)
    import torch

    from uasr_torch.config import FrontendConfig
    from uasr_torch.frontend import cuda_frontend as k
    from uasr_torch.frontend.features import make_frontend_state, num_frames_static

    if not torch.cuda.is_available():
        print("time_frontend: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    ms = _timer(torch, args.reps)
    tiles = ([tuple(int(v) for v in t.split("x")) for t in args.tile]
             if (args.tile and hasattr(k, "FORCE_TILE")) else [None])
    saved = torch.load(args.against) if args.against else None
    outs = {}
    for name, fused, B, L, over, want_energy in MAIN + SMALL:
        if args.only and not any(o in name for o in args.only):
            continue
        cfg = FrontendConfig(**{"num_mel_bins": 80, **over})
        state = make_frontend_state(cfg, device=dev)
        FL, FS, NFFT = cfg.frame_length, cfg.frame_shift, cfg.n_fft
        T = num_frames_static(L, FL, FS)
        NB, M = NFFT // 2 + 1, cfg.num_mel_bins
        nnz = int((state.mel_fb != 0).sum())
        audio = torch.tensor((0.1 * np.random.RandomState(SEED + L).randn(B, L)).astype(
            np.float32), device=dev)
        run = k.log_mel_fused_cuda if fused else k.log_mel_unfused_cuda
        plain = k.log_mel_fused_reference if fused else k.log_mel_unfused_reference
        stamped = getattr(k, "log_mel_fused_phases" if fused else "log_mel_unfused_phases", None)
        call = (audio, state, FL, FS, NFFT)
        for tier, tol, products, dtype in TIERS:
            ref = plain(*call, precision=tier, want_energy=want_energy)
            t_plain = ms(lambda: plain(*call, precision=tier, want_energy=want_energy))
            for g in tiles:
                if g is not None:
                    if g not in k.TILES[tier]:
                        continue
                    k.FORCE_TILE = g
                rec = dict(case=name, kernel="K1" if fused else "K7", B=B, L=L, T=T, FL=FL,
                           n_fft=NFFT, M=M, mel_nnz=nnz, want_energy=want_energy, tier=tier)
                try:
                    got = run(*call, precision=tier, want_energy=want_energy)
                    torch.cuda.synchronize()
                except (RuntimeError, ValueError) as e:
                    rec["error"] = str(e)
                    print(json.dumps(rec), flush=True)
                    continue
                rec["plan"] = _plan(k, B, T, NB, tier)
                rec["max_abs_err"] = float((got - ref).abs().max())
                rec["n_diff_plain"] = _ndiff(torch, got, ref)
                rec["tol"] = tol
                rec["ok"] = bool(torch.isfinite(got).all()) and rec["max_abs_err"] <= tol
                rec["ms"] = ms(lambda: run(*call, precision=tier, want_energy=want_energy))
                rec["plain_ms"] = t_plain
                rec["bound_ms"], rec["bound_by"] = bound(fused, B, L, T, FL, NB, M, nnz,
                                                         want_energy, products, dtype)
                key = f"{name}/{tier}"
                outs.setdefault(key, got.cpu())
                if saved is not None:
                    rec["against_ndiff"] = (_ndiff(torch, got.cpu(), saved[key])
                                            if key in saved else None)
                if stamped is not None:
                    got_s, cyc = stamped(*call, precision=tier, want_energy=want_energy)
                    torch.cuda.synchronize()
                    rec["phases_equal"] = _ndiff(torch, got_s, got) == 0
                    tot = cyc.sum(0).double()
                    rec["phases"] = dict(zip(k.PHASE_NAMES, (tot / tot.sum()).tolist()))
                    rec["cycles_per_cta"] = float(tot.sum() / cyc.shape[0])
                    rec["ms_stamped"] = ms(lambda: stamped(*call, precision=tier,
                                                           want_energy=want_energy))
                print(json.dumps(rec), flush=True)
            if hasattr(k, "FORCE_TILE"):
                k.FORCE_TILE = None
    if args.save:
        torch.save(outs, args.save)
    return 0


if __name__ == "__main__":
    sys.exit(main())
