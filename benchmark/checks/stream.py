"""The streaming cell's check.

The reference computes each utterance offline: streaming-CMVN features of
its chunk-padded audio, the ``cnn`` encoder over the whole utterance
(masked at its valid frames), and the exact prefix beam at the recipe's
width, cut to the recipe's ``max_label_len`` tokens as a served
transcript is. Window replay with a bounded receptive field makes a chunk's
features and its decoded region's logits equal to the offline ones at the
same absolute frames, and the final beam transcript equal to the offline
beam's.

Numbers: ``features`` (the sampled slots' window rows of the sampled
ticks) and ``logits`` (their decoded region's rows), ||d|| / ||reference||
over the valid rows; ``transcript``, over a sample of the
finished utterances drawn from the seed with the longest among them, the
widest gap in nats by which a served transcript's CTC log-likelihood under
the reference's log-probabilities lies below the reference beam's.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.checks.common import rel_rms
from benchmark.reference.beam import prefix_beam
from benchmark.reference.ctc import loglik
from benchmark.reference.fbank import Fbank
from benchmark.reference.models import encode
from benchmark.reference.precision import Cast, no_tf32

INF = {"features": math.inf, "logits": math.inf, "transcript": math.inf,
       "transcript_mean": math.inf}


def sample(loop) -> list[int]:
    """Finished utterances to judge: drawn from the seed, the longest in."""
    done = sorted(loop.finals)
    if not done:
        return []
    rng = np.random.default_rng(loop.seed + 2)
    n = min(loop.work["check"]["utterances"], len(done))
    pick = set(rng.choice(done, n, replace=False).tolist())
    B = loop.backlog
    pick.add(max(done, key=lambda u: int(B.samples[u % len(B)])))
    return sorted(pick)


@no_tf32()
def reference(loop, utts: list[int], precision: str = "float32") -> dict:
    """Per utterance (backlog position): features, logits, log-probs, best."""
    recipe, dev, B = loop.conf["recipe"], loop.dev, loop.backlog
    cast = Cast(precision)
    lens = [int(B.samples[u % len(B)]) for u in utts]
    audio = torch.zeros(len(utts), max(lens), device=dev)
    for i, u in enumerate(utts):
        audio[i, : lens[i]] = torch.as_tensor(B.audio(u % len(B)), device=dev)
    alen = torch.tensor(lens, device=dev)
    with torch.no_grad():
        feats, vf = Fbank(recipe["frontend"], dev, cast).streaming(audio, alen)
        logits, olen = encode(loop.w0, recipe["model"], feats, vf, cast)
        logp = torch.log_softmax(logits, -1)
    best = prefix_beam(logp, olen, recipe["ctc"]["beam_width"], recipe["ctc"].get("blank_id", 0))
    # a served transcript holds at most data.max_label_len tokens
    cap = recipe["data"]["max_label_len"]
    best = [h[:cap] for h in best]
    return {u: {"feats": feats[i], "vf": int(vf[i]), "logits": logits[i], "vlog": int(olen[i]),
                "logp": logp[i], "hyp": best[i]} for i, u in enumerate(utts)}


def chunk_rows(loop, ref: dict):
    """(program rows, reference rows) of the captured chunks' features and
    decoded logits, at the same absolute frames."""
    C, W, s = loop.geom
    fp, fr, lp, lr = [], [], [], []
    for info, (buf, _lens, logits) in loop.captured:
        for j, (_slot, u, k) in enumerate(info):
            r = ref[u]
            n = (k + 1) * C
            a = max(n - W, 0)
            rows = max(min(n, W, r["vf"] - a), 0)
            fp.append(buf[j, :rows])
            fr.append(r["feats"][a: a + rows])
            if k >= 1:
                t0 = (n - 2 * C) // s
                cnt = int(np.clip(r["vlog"] - t0, 0, C // s))
                off = (n - 2 * C - a) // s
                lp.append(logits[j, off: off + cnt].float())
                lr.append(r["logits"][t0: t0 + cnt])
    return fp, fr, lp, lr


def _gap_rows(got: list, ref: list) -> float:
    if not got:
        return math.inf
    return rel_rms(torch.cat(got), torch.cat(ref))


def transcript_gaps(ref: dict, hyps: dict, blank: int) -> dict:
    gaps = []
    for u, hyp in hyps.items():
        r = ref[u]
        lens = torch.tensor([r["vlog"]], device=r["logp"].device)
        ll = loglik(r["logp"][None].expand(2, -1, -1), lens.expand(2), [hyp, r["hyp"]], blank)
        gaps.append(max(float(ll[1] - ll[0]), 0.0))
    if not gaps:
        return {"transcript": math.inf, "transcript_mean": math.inf}
    return {"transcript": max(gaps), "transcript_mean": sum(gaps) / len(gaps)}


def readings(loop) -> dict:
    judged = sample(loop)
    utts = sorted(set(judged) | {u for info, _ in loop.captured for _, u, _ in info})
    if not judged or not loop.captured:
        return dict(INF)
    ref = reference(loop, utts)
    fp, fr, lp, lr = chunk_rows(loop, ref)
    blank = loop.conf["recipe"]["ctc"].get("blank_id", 0)
    return {"features": _gap_rows(fp, fr), "logits": _gap_rows(lp, lr),
            **transcript_gaps(ref, {u: loop.finals[u] for u in judged}, blank)}


def control(loop, precision: str) -> dict:
    """The reference in ``precision`` in the program's place: its offline
    rows at the captured chunks' frames, its beam's transcripts."""
    judged = sample(loop)
    utts = sorted(set(judged) | {u for info, _ in loop.captured for _, u, _ in info})
    ref, low = reference(loop, utts), reference(loop, utts, precision)
    fp, fr, lp, lr = chunk_rows(loop, ref)
    cp, _, cl, _ = chunk_rows(_Stand(loop, low), ref)
    blank = loop.conf["recipe"]["ctc"].get("blank_id", 0)
    return {"features": _gap_rows(cp, fr), "logits": _gap_rows(cl, lr),
            **transcript_gaps(ref, {u: low[u]["hyp"] for u in judged}, blank)}


class _Stand:
    """The loop's captured chunks with the rows taken from ``rows`` (offline
    outputs laid out as the window would hold them)."""

    def __init__(self, loop, rows: dict):
        C, W, s = loop.geom
        self.geom = loop.geom
        self.captured = []
        for info, _ in loop.captured:
            bufs, logs = [], []
            for _slot, u, k in info:
                n = (k + 1) * C
                a = max(n - W, 0)
                f = rows[u]["feats"][a: a + W]
                lg = rows[u]["logits"][a // s: (a + W) // s]
                bufs.append(torch.nn.functional.pad(f, (0, 0, 0, W - f.shape[0])))
                logs.append(torch.nn.functional.pad(lg, (0, 0, 0, W // s - lg.shape[0])))
            self.captured.append((info, (torch.stack(bufs), None, torch.stack(logs))))
