"""Time K2-bwd (the BiGRU backward) on the card at the librispeech_ctc_bigru
training step's shape (T = 400, B = 32, H = 512: a 16 s batch), with
cuDNN's bidirectional GRU backward beside it:

  python -m uasr_torch.tools.time_bigru_bwd [--reps 10]

Prints one JSON line per dtype and length mix (ragged, lengths 1 to T, or
every row live for all T steps): K2-bwd's time, its coefficient kernel and
reverse chain alone where the checkout has them apart, its largest error
against the plain version relative to the largest reference value, its
plan, and cuDNN's nn.GRU(bidirectional) forward + backward minus forward.
It uses only bigru_scan_cuda and bigru_scan_bwd_cuda otherwise, so the same
file run from an older checkout times that checkout's kernel (the way two
trees are compared within one call on one card; copy ``time_bigru_fwd``,
whose inputs and timer it uses, beside it).
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

    from uasr_torch.models import cuda_gru as k2
    from uasr_torch.tools.time_bigru_fwd import B, CASES, H, T, bigru_problem, timer

    if not torch.cuda.is_available():
        print("time_bigru_bwd: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    ms = timer(torch, args.reps)

    def rel(got, ref):
        return max(float((a.float() - r.float()).abs().max()) for a, r in zip(got, ref)) / max(
            1.0, max(float(r.float().abs().max()) for r in ref))

    for dtype, full in CASES:
        gen = torch.Generator(device=dev).manual_seed(11)
        dt = getattr(torch, dtype)
        a = bigru_problem(torch, dev, gen, dtype, full)
        dout = (torch.randn(T, B, 2 * H, device=dev, generator=gen) / B).to(dt)
        out = k2.bigru_scan_cuda(*a)
        rec = dict(dtype=dtype, full=full, T=T, B=B, H=H)
        rec["err"] = rel(k2.bigru_scan_bwd_cuda(*a, out, dout),
                         k2.bigru_scan_bwd_reference(*a, out, dout))
        if hasattr(k2, "LAST_BIGRU_BWD_PLAN"):
            rec["plan"] = [k2.LAST_BIGRU_BWD_WH, *k2.LAST_BIGRU_BWD_PLAN]
        else:
            rec["plan"] = [k2.LAST_UNITS_BWD]
        rec["ms"] = ms(lambda: k2.bigru_scan_bwd_cuda(*a, out, dout))
        if hasattr(k2, "bigru_bwd_coeffs_cuda"):
            c4, ch = k2.bigru_bwd_coeffs_cuda(*a, out)
            rec["ms_coeffs"] = ms(lambda: k2.bigru_bwd_coeffs_cuda(*a, out))
            rec["ms_chain"] = ms(lambda: k2.bigru_bwd_chain_cuda(c4, ch, a[2], dout))
        gru = torch.nn.GRU(2 * H, H, bidirectional=True).to(device=dev, dtype=dt)
        gru.flatten_parameters()
        x = torch.randn(T, B, 2 * H, device=dev, generator=gen).to(dt).requires_grad_()
        gy = torch.randn(T, B, 2 * H, device=dev, generator=gen).to(dt)
        fwd = ms(lambda: gru(x)[0])
        rec["ms_cudnn_bwd"] = ms(lambda: gru(x)[0].backward(gy)) - fwd
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
