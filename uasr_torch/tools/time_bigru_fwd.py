"""Time K2 (the BiGRU forward) on the card at the librispeech_ctc_bigru
decode and training shape (T = 400, B = 32, H = 512: a 16 s batch), with
cuDNN's bidirectional GRU forward beside it:

  python -m uasr_torch.tools.time_bigru_fwd [--reps 10]

Prints one JSON line per dtype and length mix (ragged, lengths 1 to T, or
every row live for all T steps): K2's time, its largest error against the
plain version, its plan (wh resident or streamed, hidden units per CTA and
batch splits, or the units per CTA where the checkout reports only those),
and cuDNN's nn.GRU(bidirectional) forward on the same unmasked shape. It
uses only bigru_scan_cuda and bigru_scan_reference, so the same file run
from an older checkout times that checkout's kernel (the way two trees are
compared within one call on one card). ``time_bigru_bwd`` builds its
inputs and times with the helpers here.
"""

from __future__ import annotations

import argparse
import json
import sys

T, B, H = 400, 32, 512
CASES = (("bfloat16", False), ("bfloat16", True), ("float32", False), ("float32", True))


def timer(torch, reps: int):
    """ms(fn): the mean time of ``reps`` calls by CUDA events, after one."""

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


def bigru_problem(torch, dev, gen, dtype: str, full: bool):
    """K2's inputs (p0, p1, wh, bh in ``dtype``, tmask) at T, B, H drawn
    from ``gen``: lengths 1 to T (the first T, the second 1), or every row
    live."""
    lengths = torch.randint(1, T + 1, (B,), device=dev, generator=gen)
    lengths[0], lengths[1] = T, 1
    if full:
        lengths.fill_(T)
    tpos = torch.arange(T, device=dev)[:, None]
    tmask = torch.stack([tpos < lengths[None], tpos >= (T - lengths)[None]], 1)
    p0 = 0.5 * torch.randn(T, B, 3 * H, device=dev, generator=gen)
    p1 = 0.5 * torch.randn(T, B, 3 * H, device=dev, generator=gen)
    wh = torch.randn(2, H, 3 * H, device=dev, generator=gen) / H ** 0.5
    bh = 0.1 * torch.randn(2, 3 * H, device=dev, generator=gen)
    return tuple(x.to(getattr(torch, dtype)).contiguous() for x in (p0, p1, wh, bh)) + (tmask,)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    import torch

    from uasr_torch.models import cuda_gru as k2

    if not torch.cuda.is_available():
        print("time_bigru_fwd: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    ms = timer(torch, args.reps)
    for dtype, full in CASES:
        gen = torch.Generator(device=dev).manual_seed(13)
        dt = getattr(torch, dtype)
        a = bigru_problem(torch, dev, gen, dtype, full)
        got = k2.bigru_scan_cuda(*a)
        rec = dict(dtype=dtype, full=full, T=T, B=B, H=H)
        rec["err"] = float((got.float() - k2.bigru_scan_reference(*a).float()).abs().max())
        plan = getattr(k2, "LAST_BIGRU_PLAN", None)
        rec["plan"] = ([k2.LAST_BIGRU_WH, *plan] if plan is not None
                       else [getattr(k2, "LAST_UNITS", None)])
        rec["ms"] = ms(lambda: k2.bigru_scan_cuda(*a))
        gru = torch.nn.GRU(2 * H, H, bidirectional=True).to(device=dev, dtype=dt)
        gru.flatten_parameters()
        x = torch.randn(T, B, 2 * H, device=dev, generator=gen).to(dt)
        with torch.inference_mode():
            rec["ms_cudnn"] = ms(lambda: gru(x))
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
