"""Time the grouped GRU forward kernel K5 on the card at lc_bigru's and
uni_gru's shapes (H = 384: the 12 s forward GRU offline, T = 300, B = 64;
the backward windows, T = 24, B = 64 x 19; one streaming step's windows,
T = 24, B = 64), with cuDNN's GRU forward beside it:

  python -m uasr_torch.tools.time_gru_fwd [--reps 20]

Prints one JSON line per shape, dtype and length mix (ragged, or every
row live for all T steps) in f32, and in bf16 at the windows: K5's time,
its largest error against the plain version, its plan (hidden units per
CTA and batch splits, and wh resident or streamed where the checkout
reports it), and cuDNN's unidirectional nn.GRU forward on the same
unmasked shape. It uses only the wrapper's public names, so the same file
run from an older checkout times that checkout's K5 (the way two trees are
compared within one call on one card).
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    import torch

    from uasr_torch.models import cuda_gru as k5

    if not torch.cuda.is_available():
        print("time_gru_fwd: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    def ms(fn):
        fn()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(args.reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / args.reps

    H = 384
    for what, T, rows in (("offline", 300, 64), ("windows", 24, 64 * 19), ("step", 24, 64)):
        mixes = [("float32", False), ("float32", True)]
        if what == "windows":
            mixes += [("bfloat16", False), ("bfloat16", True)]
        for dtype, full in mixes:
            gen = torch.Generator(device=dev).manual_seed(7 + T + rows)
            dt = getattr(torch, dtype)
            lengths = torch.randint(0, T + 1, (rows,), device=dev, generator=gen)
            lengths[0], lengths[-1] = T, 0
            if full:
                lengths.fill_(T)
            tmask = (torch.arange(T, device=dev)[:, None] < lengths[None])[:, None]
            xp = 0.5 * torch.randn(T, 1, rows, 3 * H, device=dev, generator=gen)
            wh = torch.randn(1, H, 3 * H, device=dev, generator=gen) / H ** 0.5
            bh = 0.1 * torch.randn(1, 3 * H, device=dev, generator=gen)
            a = tuple(x.to(dt).contiguous() for x in (xp, wh, bh))
            got = k5.gru_scan_cuda(*a, tmask)
            ref = k5.gru_scan_reference(*a, tmask)
            rec = dict(what=what, dtype=dtype, full=full, T=T, B=rows, H=H)
            rec["err"] = float((got.float() - ref.float()).abs().max())
            rec["plan"] = k5.LAST_GRU_PLAN
            rec["wh"] = getattr(k5, "LAST_GRU_WH", None)
            rec["ms"] = ms(lambda: k5.gru_scan_cuda(*a, tmask))
            gru = torch.nn.GRU(H, H).to(device=dev, dtype=dt)
            gru.flatten_parameters()
            x = torch.randn(T, rows, H, device=dev, generator=gen).to(dt)
            with torch.inference_mode():
                rec["ms_cudnn"] = ms(lambda: gru(x))
            print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
