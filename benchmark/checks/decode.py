"""The decode cell's check, on the requests the loop sampled.

The reference recomputes each sampled request from its host audio: the
features (utterance CMVN), the logits, and the exact prefix beam at the
recipe's width. Numbers: ``features`` and ``logits``, ||d|| / ||reference||
over the valid rows, worst request; ``transcript``, the widest
gap, in nats, by which a served transcript's CTC log-likelihood under the
reference's log-probabilities lies below that of the reference's own best
transcript (0 where the served one scores as well or better).
"""

from __future__ import annotations

import math

import torch

from benchmark.checks.common import rel_rms, valid_rows
from benchmark.reference.beam import prefix_beam
from benchmark.reference.ctc import loglik
from benchmark.reference.fbank import Fbank
from benchmark.reference.models import encode
from benchmark.reference.precision import Cast, no_tf32


@no_tf32()
def reference(loop, batch, precision: str = "float32") -> dict:
    recipe, dev = loop.conf["recipe"], loop.dev
    cast = Cast(precision)
    audio, alen = (torch.as_tensor(x, device=dev) for x in batch[:2])
    with torch.no_grad():
        feats, flen = Fbank(recipe["frontend"], dev, cast).utterance(audio, alen.long())
        logits, olen = encode(loop.w0, recipe["model"], feats, flen, cast)
        logp = torch.log_softmax(logits, -1)
    best = prefix_beam(logp, olen, recipe["ctc"]["beam_width"], recipe["ctc"].get("blank_id", 0))
    return {"feats": feats, "feat_len": flen, "logits": logits, "enc_len": olen, "logp": logp,
            "hyps": best}


def gaps(got: dict, ref: dict, blank: int) -> dict:
    if not (torch.equal(got["feat_len"].cpu(), ref["feat_len"].cpu())
            and torch.equal(got["enc_len"].cpu(), ref["enc_len"].cpu())
            and len(got["hyps"]) == len(ref["hyps"])):
        return {"features": math.inf, "logits": math.inf, "transcript": math.inf,
                "transcript_mean": math.inf}
    ll_got = loglik(ref["logp"], ref["enc_len"], got["hyps"], blank)
    ll_ref = loglik(ref["logp"], ref["enc_len"], ref["hyps"], blank)
    return {
        "features": rel_rms(valid_rows(got["feats"], ref["feat_len"]),
                            valid_rows(ref["feats"], ref["feat_len"])),
        "logits": rel_rms(valid_rows(got["logits"].float(), ref["enc_len"]),
                          valid_rows(ref["logits"], ref["enc_len"])),
        "transcript": float((ll_ref - ll_got).clamp(min=0).max()),
        "transcript_mean": float((ll_ref - ll_got).clamp(min=0).mean()),
    }


def _worst(rows: list[dict]) -> dict:
    if not rows:
        return {"features": math.inf, "logits": math.inf, "transcript": math.inf}
    out = {k: max(r[k] for r in rows) for k in rows[0]}
    out["transcript_mean"] = sum(r["transcript_mean"] for r in rows) / len(rows)
    return out


def readings(loop) -> dict:
    blank = loop.conf["recipe"]["ctc"].get("blank_id", 0)
    rows = []
    for i, (k, hyps, (feats, flen, logits, olen)) in sorted(loop.served.items()):
        got = {"feats": feats, "feat_len": flen, "logits": logits, "enc_len": olen,
               "hyps": hyps}
        rows.append(gaps(got, reference(loop, loop.pool[k]), blank))
    return _worst(rows)


def control(loop, precision: str) -> dict:
    blank = loop.conf["recipe"]["ctc"].get("blank_id", 0)
    return _worst([gaps(reference(loop, loop.pool[k], precision), reference(loop, loop.pool[k]),
                        blank) for k, _, _ in loop.served.values()])
