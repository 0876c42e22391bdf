"""Time K4 (the exact CTC prefix beam) on the card at the main path's
shapes, and split its step by phase:

  python -m uasr_torch.tools.time_beam [--reps 10]

The cases: (a) the beam-16 offline decode of librispeech_ctc_bigru, T =
400, B = 32, W = 16, V = 32, lengths 1 to T, without an LM, with a bigram
and with a trigram; (b) one streaming chunk of aishell_streaming, T = 32,
B = 64, W = 8, V = 4233, from the state a first chunk left; (c) its 12 s
offline pass, T = 600, from a fresh state.

Prints one JSON line per case: K4's time (CUDA events, the mean of
``--reps`` launches after one), the µs per step of the longest utterance,
whether backpointers and state are bit-equal to the plain version, and the
plan (warps per CTA, CTAs per utterance). Where the checkout has the
stamped build (``ctc_beam_phases``) it adds the phase split: each phase's
share of the clock cycles of every CTA's thread 0, the longest utterance's
cycles per step, the µs per step that share takes of the unstamped time,
and the stamped build's own time. It calls only ``ctc_beam_cuda`` and
``ctc_beam_reference`` otherwise, so the same file run from an older
checkout times that checkout's kernel.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

SEED = 0
DECODE = dict(T=400, B=32, W=16, V=32)
STREAM = dict(B=64, W=8, V=4233, chunk=32, offline=600)


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


def _logp(torch, gen, B, T, V, dev):
    return torch.log_softmax(4.0 * torch.randn(B, T, V, device=dev, generator=gen),
                             -1).contiguous()


def cases(torch, k4, dev):
    """(name, args, state) at the main path's shapes, drawn from a seed."""
    out = []
    T, B, W, V = DECODE["T"], DECODE["B"], DECODE["W"], DECODE["V"]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    logp = _logp(torch, gen, B, T, V, dev)
    lengths = torch.randint(1, T + 1, (B,), device=dev, generator=gen)
    lengths[0], lengths[1] = T, 1
    rng = np.random.RandomState(SEED)
    for name, order in (("decode:none", 0), ("decode:bigram", 2), ("decode:trigram", 3)):
        lm = None
        if order:
            tab = np.log(rng.dirichlet(np.ones(V), (V + 1) ** (order - 1)))
            lm = torch.tensor(tab, dtype=torch.float32, device=dev)
        out.append((name, (logp, lengths, W, 0, lm, order, 0.5, 0.3), None))
    B, W, V = STREAM["B"], STREAM["W"], STREAM["V"]
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    for name, T, carried in (("stream:chunk", STREAM["chunk"], True),
                             ("stream:offline", STREAM["offline"], False)):
        logp = _logp(torch, gen, B, T, V, dev)
        lengths = torch.randint(0, T + 1, (B,), device=dev, generator=gen)
        lengths[0], lengths[1] = T, (0 if carried else 1)
        state = None
        if carried:  # the state a first chunk of T frames left
            first = _logp(torch, gen, B, T, V, dev)
            state = k4.ctc_beam_reference(first, torch.full((B,), T, device=dev), W)[2]
        out.append((name, (logp, lengths, W, 0), state))
    return out


def _equal(torch, got, ref) -> bool:
    return all(bool(torch.equal(a, b)) for a, b in zip((*got[:2], *got[2]), (*ref[:2], *ref[2])))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    import torch

    from uasr_torch.ops import cuda_beam as k4

    if not torch.cuda.is_available():
        print("time_beam: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    ms = _timer(torch, args.reps)
    stamped = getattr(k4, "ctc_beam_phases", None)
    for name, a, state in cases(torch, k4, dev):
        B, T, V = a[0].shape
        W = a[2]
        steps = int(a[1].clamp(max=T).max())
        got = k4.ctc_beam_cuda(*a, state=state)
        rec = dict(case=name, T=T, B=B, W=W, V=V, lm_order=a[5] if len(a) > 5 else 0)
        rec["equal"] = _equal(torch, got, k4.ctc_beam_reference(*a, state=state))
        # a checkout that does not report its plan ran one CTA per utterance,
        # one warp up to W * V = 2048 and eight above
        rec["plan"] = list(getattr(k4, "LAST_BEAM_PLAN", (1 if W * V <= 2048 else 8, 1)))
        rec["ms"] = ms(lambda: k4.ctc_beam_cuda(*a, state=state))
        rec["us_per_step"] = rec["ms"] * 1e3 / steps
        if stamped is not None:
            *out, cyc = stamped(*a, state=state)
            rec["phases_equal"] = _equal(torch, out, got)
            tot = cyc.sum(0).double()
            share = (tot / tot.sum()).tolist()
            longest = int(a[1].clamp(max=T).argmax())
            rec["phase_share"] = dict(zip(k4.PHASE_NAMES, share))
            rec["phase_cycles_per_step"] = dict(
                zip(k4.PHASE_NAMES, (cyc[longest].double() / steps).tolist()))
            rec["phase_us_per_step"] = {n: s * rec["us_per_step"]
                                        for n, s in zip(k4.PHASE_NAMES, share)}
            rec["ms_stamped"] = ms(lambda: stamped(*a, state=state))
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
