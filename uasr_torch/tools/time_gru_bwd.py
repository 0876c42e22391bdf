"""Time the grouped GRU backward kernels on the card at lc_bigru's
training shapes (H = 384: the 12 s forward GRU, T = 300, B = 64, and the
backward windows, T = 24, B = 64 x 19), with cuDNN's GRU backward beside
them:

  python -m uasr_torch.tools.time_gru_bwd [--reps 10]

Prints one JSON line per shape, dtype and length mix (ragged, or every
row live for all T steps): K5-bwd, its coefficient kernel alone where the
checkout has one, K8, their largest error against the plain versions
relative to the largest reference value, and cuDNN's nn.GRU forward +
backward minus forward. It uses only the wrappers' public names, so the
same file run from an older checkout times that checkout's kernels (the
way two trees are compared within one call on one card).
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    import torch

    from uasr_torch.models import cuda_gru as k5

    if not torch.cuda.is_available():
        print("time_gru_bwd: no CUDA device", file=sys.stderr)
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

    def rel(got, ref):
        return max(float((a.float() - r.float()).abs().max()) for a, r in zip(got, ref)) / max(
            1.0, max(float(r.float().abs().max()) for r in ref))

    H = 384
    for what, T, rows in (("offline", 300, 64), ("windows", 24, 64 * 19)):
        for dtype, full in (("float32", False), ("bfloat16", False), ("float32", True)):
            gen = torch.Generator(device=dev).manual_seed(7 + T)
            dt = getattr(torch, dtype)
            lengths = torch.randint(0, T + 1, (rows,), device=dev, generator=gen)
            lengths[0], lengths[-1] = T, 0
            if full:
                lengths.fill_(T)
            tmask = (torch.arange(T, device=dev)[:, None] < lengths[None])[:, None]
            xp = 0.5 * torch.randn(T, 1, rows, 3 * H, device=dev, generator=gen)
            wh = torch.randn(1, H, 3 * H, device=dev, generator=gen) / H ** 0.5
            bh = 0.1 * torch.randn(1, 3 * H, device=dev, generator=gen)
            dy = (torch.randn(T, 1, rows, H, device=dev, generator=gen) / rows).to(dt)
            a = tuple(x.to(dt).contiguous() for x in (xp, wh, bh))
            ys, c4, ch = k5.gru_scan_cuda(*a, tmask, save_coeffs=True)
            rec = dict(what=what, dtype=dtype, full=full)
            rec["err"] = rel(k5.gru_scan_bwd_cuda(*a, tmask, ys, dy),
                             k5.gru_scan_bwd_reference(*a, tmask, ys, dy))
            rec["plan"] = k5.LAST_GRU_BWD_PLAN
            rec["err_lin"] = rel([k5.gru_scan_bwd_lin_cuda(c4, ch, dy, a[1])],
                                 [k5.gru_scan_bwd_lin_reference(c4, ch, dy, a[1])])
            rec["ms_bwd"] = ms(lambda: k5.gru_scan_bwd_cuda(*a, tmask, ys, dy))
            if hasattr(k5, "gru_bwd_coeffs_cuda"):
                rec["ms_coeffs"] = ms(lambda: k5.gru_bwd_coeffs_cuda(*a, tmask, ys))
            rec["ms_lin"] = ms(lambda: k5.gru_scan_bwd_lin_cuda(c4, ch, dy, a[1]))
            gru = torch.nn.GRU(H, H).to(device=dev, dtype=dt)
            gru.flatten_parameters()
            x = torch.randn(T, rows, H, device=dev, generator=gen).to(dt).requires_grad_()
            gy = torch.randn(T, rows, H, device=dev, generator=gen).to(dt)
            fwd = ms(lambda: gru(x)[0])
            rec["ms_cudnn_bwd"] = ms(lambda: gru(x)[0].backward(gy)) - fwd
            print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
