"""Time K3 and K3-bwd (the CTC alpha and beta recursions) on the card at the
training step's shapes, and split their step by phase:

  python -m uasr_torch.tools.time_ctc [--reps 10] [--depth D ...]

The cases: (a) the librispeech 16 s bucket as ``chip_smoke.py`` builds it,
T = 400, B = 32, U = 256 (S = 513), V = 32, logit lengths uniform in T/4..T
with one full row and one zero-length row, 14 characters per 25 frames;
(b) the 12 s bucket of the lc_bigru training step on aishell_streaming,
B = 64, 8 to 12 s of audio (one exactly 12 s), about 4 characters a second
padded to max_label_len 64 (S = 129), V = 4233.

Prints one JSON line per case (and per ``--depth``, where the kernels take
one): K3's and K3-bwd's times (CUDA events, the mean of ``--reps`` launches
after one), the µs per step of the longest row, the errors against the
plain versions at the card's bars (alpha max |d| / (1 + |ref|) <= 1e-6, ll
<= 1e-3, d(emit) <= 1e-5, the zero-length row zero), F.ctc_loss's forward
and its forward + backward minus forward in the same call, and the plan
(threads, ring depth) of each kernel. Where the checkout has the stamped
builds (``ctc_alpha_phases``, ``ctc_beta_phases``: thread 0's clock64 per
phase; the compiler moves arithmetic across stamps, so shares are
approximate) it adds the phase split. It calls only ``ctc_alpha_cuda``,
``ctc_beta_cuda`` and the plain versions otherwise, so the same file run
from an older checkout times that checkout's kernels.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

SEED = 0
LIBRI = dict(T=400, B=32, U=256, V=32)
AISHELL = dict(B=64, seconds=12.0, U=64, V=4233, cps=4.0, sample_rate=16000, frame_length=400,
               frame_shift=160, conv_stride=2, conv_layers=2)


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


def cases(torch, dev):
    """(name, logits [B, T, V], logit lengths, labels, label lengths), drawn
    from a seed."""
    T, B, U, V = LIBRI["T"], LIBRI["B"], LIBRI["U"], LIBRI["V"]
    rng = np.random.RandomState(SEED + 1)
    llen = rng.randint(T // 4, T + 1, B)
    llen[0], llen[1] = T, 0  # a full row and a zero-length padding row
    ulen = np.minimum(llen * 14 // 25, U)
    labels = rng.randint(1, V, (B, U))
    labels[np.arange(U)[None, :] >= ulen[:, None]] = 0
    out = [("a:librispeech_16s", 3.0 * rng.randn(B, T, V), llen, labels, ulen)]
    c = AISHELL
    B, U, V = c["B"], c["U"], c["V"]
    rng = np.random.RandomState(SEED + 2)
    secs = rng.uniform(c["seconds"] - 4.0, c["seconds"], B)
    secs[0] = c["seconds"]
    # frames of the audio, then the front's stride-2 convolutions
    frames = 1 + ((secs * c["sample_rate"]).astype(np.int64) - c["frame_length"]) // c[
        "frame_shift"]
    for _ in range(c["conv_layers"]):
        frames = (frames + c["conv_stride"] - 1) // c["conv_stride"]
    T = int(frames.max())
    ulen = np.minimum((secs * c["cps"]).astype(np.int64), U)
    labels = rng.randint(1, V - 3, (B, U))
    labels[np.arange(U)[None, :] >= ulen[:, None]] = 0
    out.append(("b:aishell_lc_bigru_12s", 3.0 * rng.randn(B, T, V), frames, labels, ulen))
    return [(name, torch.tensor(lg, dtype=torch.float32, device=dev),
             *(torch.tensor(a, dtype=torch.int64, device=dev) for a in (ll, lab, ul)))
            for name, lg, ll, lab, ul in out]


def _split(k3, cyc, steps, us_per_step, longest):
    tot = cyc.sum(0).double()
    share = (tot / tot.sum()).tolist()
    return dict(share=dict(zip(k3.PHASE_NAMES, share)),
                cycles_per_step=dict(zip(k3.PHASE_NAMES,
                                         (cyc[longest].double() / steps).tolist())),
                us_per_step={n: s * us_per_step for n, s in zip(k3.PHASE_NAMES, share)})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--depth", type=int, action="append",
                    help="ring depth to time (repeatable; kernels that take one)")
    args = ap.parse_args(argv)
    import torch

    from uasr_torch.ops import cuda_ctc as k3

    if not torch.cuda.is_available():
        print("time_ctc: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    ms = _timer(torch, args.reps)
    # a checkout whose kernels take no ring depth loaded one step ahead
    ringed = hasattr(k3, "RING_DEPTH")
    depths = args.depth if (ringed and args.depth) else [None]
    stamped = hasattr(k3, "ctc_alpha_phases")
    for name, logits, llen, labels, ulen in cases(torch, dev):
        emit, act, skip, svalid, finals = k3.ctc_inputs(logits, llen, labels, ulen)
        T, B, S = emit.shape
        steps = int(act.sum(0).max())
        longest = int(act.sum(0).argmax())
        traj_ref = k3.ctc_alpha_reference(emit, act, skip, svalid)
        ll = k3.final_ll(traj_ref[-1], finals)
        g = torch.full((B,), 1.0 / B, device=dev)
        demit_ref = k3.ctc_beta_reference(emit, act, skip, finals, traj_ref, ll, g)
        zero = (llen == 0).nonzero().flatten().tolist()
        # F.ctc_loss on the same log-probabilities
        logp = torch.log_softmax(logits, -1).transpose(0, 1).detach().requires_grad_()

        def lib_fwd():
            return torch.nn.functional.ctc_loss(logp, labels, llen, ulen, reduction="sum")

        lib_a = ms(lib_fwd)
        lib_b = ms(lambda: lib_fwd().backward()) - lib_a
        for depth in depths:
            kw = {} if depth is None else dict(depth=depth)
            fa = lambda: k3.ctc_alpha_cuda(emit, act, skip, svalid, **kw)  # noqa: E731
            fb = lambda: k3.ctc_beta_cuda(emit, act, skip, finals, traj_ref, ll, g,  # noqa: E731
                                          **kw)
            traj, demit = fa(), fb()
            torch.cuda.synchronize()
            rec = dict(case=name, T=T, B=B, S=S, steps=steps)
            rec["alpha_rel_err"] = float(((traj - traj_ref).abs() / (1 + traj_ref.abs())).max())
            rec["ll_err"] = float((k3.final_ll(traj[-1], finals) - ll).abs().max())
            rec["demit_err"] = float((demit - demit_ref).abs().max())
            rec["zero_rows_zero"] = not bool(demit[:, zero].any()) if zero else None
            rec["ok"] = (rec["alpha_rel_err"] <= 1e-6 and rec["ll_err"] <= 1e-3
                         and rec["demit_err"] <= 1e-5 and rec["zero_rows_zero"] is not False)
            rec["plan_alpha"] = list(getattr(k3, "LAST_ALPHA_PLAN", None)
                                     or (min(1024, (S + 31) // 32 * 32), 1))
            rec["plan_beta"] = list(getattr(k3, "LAST_BETA_PLAN", None)
                                    or (min(1024, (S + 31) // 32 * 32), 1))
            rec["ms_alpha"] = ms(fa)
            rec["ms_beta"] = ms(fb)
            rec["us_per_step_alpha"] = rec["ms_alpha"] * 1e3 / steps
            rec["us_per_step_beta"] = rec["ms_beta"] * 1e3 / steps
            rec["ctc_loss_fwd_ms"], rec["ctc_loss_bwd_ms"] = lib_a, lib_b
            if stamped:
                pa = lambda: k3.ctc_alpha_phases(emit, act, skip, svalid, **kw)  # noqa: E731
                pb = lambda: k3.ctc_beta_phases(emit, act, skip, finals, traj_ref,  # noqa: E731
                                                ll, g, **kw)
                (traj_s, cyc_a), (demit_s, cyc_b) = pa(), pb()
                rec["phases_equal"] = bool(torch.equal(traj_s, traj)
                                           and torch.equal(demit_s, demit))
                rec["phases_alpha"] = _split(k3, cyc_a, steps, rec["us_per_step_alpha"],
                                             longest)
                rec["phases_beta"] = _split(k3, cyc_b, steps, rec["us_per_step_beta"],
                                            longest)
                rec["ms_alpha_stamped"] = ms(pa)
                rec["ms_beta_stamped"] = ms(pb)
            print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
