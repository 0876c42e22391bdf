"""The training cell's check, in two stages of three steps each.

``start``: the reference follows the program's first three steps (in
set-up) from the seed's weights and a zero optimizer state. ``warm``: it
follows the three steps the loop records once the window has closed,
from a copy of the program's state they start from (parameters, Adam's
moments and count, the step): the warm path, whatever the window's steps
left in place; only the program's own state can start it, so the start
is held apart by the first stage.

Numbers of a stage (``warm_`` in front for the second): ``features``, the
frontend's output of the stage's first step after SpecAugment, and
``logits``, that step's logits, as ||d|| / ||reference|| over the valid
rows; ``loss``, the relative gap of that step's loss, and ``loss3``, the
worst of the three steps'; ``grad``, the worst leaf's gap between the
norms of the stage's first gradient; ``change``, the worst leaf's gap
between the norms of the parameters' change over the three steps
(``checks.common.worst_leaf``, over the leaves that ``counted_leaves``
keeps). The workload file's limits say which are held (PERF.md gives the
readings that left the others out).
"""

from __future__ import annotations

import math

import torch

from benchmark.checks.common import counted_leaves, rel_rms, valid_rows, worst_leaf
from benchmark.reference import specaug
from benchmark.reference.adam import Adam
from benchmark.reference.ctc import ctc_nll
from benchmark.reference.fbank import Fbank
from benchmark.reference.models import encode
from benchmark.reference.precision import Cast, no_tf32

STAGES = {"start": "", "warm": "warm_"}


def _origin(loop, stage: str):
    """(weights, optimizer state or None, first batch, first step) of a stage."""
    if stage == "start":
        return loop.w0, None, 0, 0
    s = loop.warm["start"]
    return s["params"], s, s["first"], s["step"]


@no_tf32()
def reference_run(loop, stage: str = "start", precision: str = "float32",
                  fault: str | None = None) -> dict:
    """The reference's three steps of ``stage`` on the loop's batches.
    ``fault="half"`` takes the loss over the first half of each batch."""
    recipe, dev = loop.conf["recipe"], loop.dev
    cast = Cast(precision)
    fb = Fbank(recipe["frontend"], dev, cast)
    W0, opt_state, first, step0 = _origin(loop, stage)
    W = {k: v.detach().clone().float().requires_grad_(True) for k, v in W0.items()}
    opt = Adam(W, recipe["train"], state=opt_state)
    out = {"loss": []}
    for i in range(3):
        batch = loop.pool[(first + i) % len(loop.pool)]
        audio, alen, labels, llen = (torch.as_tensor(x, device=dev) for x in batch)
        alen, llen = alen.long(), llen.long()
        feats, flen = fb.utterance(audio, alen)
        B, T, D = feats.shape
        keep = specaug.keep_mask(loop.cfg.train.seed, step0 + i, B, T, D, flen,
                                 recipe["frontend"])
        feats = torch.where(keep, feats, 0.0)
        logits, olen = encode(W, recipe["model"], feats, flen, cast)
        nll = ctc_nll(torch.log_softmax(logits, -1), olen, labels, llen,
                      recipe["ctc"].get("blank_id", 0))
        loss = (nll[: B // 2] if fault == "half" else nll).mean()
        grads = dict(zip(W, torch.autograd.grad(loss, list(W.values()))))
        out["loss"].append(float(loss.detach()))
        if i == 0:
            out.update(feats=feats, feat_len=flen, logits=logits.detach(), enc_len=olen)
            out["grad"] = {k: float(g.norm()) for k, g in grads.items()}
        opt.step({k: w.data for k, w in W.items()}, grads)
    out["change"] = {k: float((W[k].detach() - W0[k]).norm()) for k in W}
    return out


def compare(got: dict, ref: dict) -> dict:
    same_len = torch.equal(got["feat_len"].cpu(), ref["feat_len"].cpu()) and torch.equal(
        got["enc_len"].cpu(), ref["enc_len"].cpu())
    keep = counted_leaves(ref["grad"])
    if not same_len:
        feats = logits = math.inf
    else:
        feats = rel_rms(valid_rows(got["feats"], ref["feat_len"]),
                        valid_rows(ref["feats"], ref["feat_len"]))
        logits = rel_rms(valid_rows(got["logits"].float(), ref["enc_len"]),
                         valid_rows(ref["logits"], ref["enc_len"]))
    return {
        "features": feats,
        "logits": logits,
        "loss": abs(got["loss"][0] - ref["loss"][0]) / abs(ref["loss"][0]),
        "loss3": max(abs(a - b) / abs(b) for a, b in zip(got["loss"], ref["loss"])),
        "grad": worst_leaf(got["grad"], ref["grad"], keep)[0],
        "change": worst_leaf(got["change"], ref["change"], keep)[0],
    }


def _both(got: dict, ref: dict) -> dict:
    return {p + k: v for s, p in STAGES.items() for k, v in compare(got[s], ref[s]).items()}


def _reference(loop) -> dict:
    """The float32 reference of both stages, once a loop."""
    if getattr(loop, "reference", None) is None:
        loop.reference = {s: reference_run(loop, s) for s in STAGES}
    return loop.reference


def readings(loop) -> dict:
    """The program's numbers (the loop's recorded outputs) against the
    reference. Run once the window has closed and the program is freed."""
    return _both({"start": loop.out, "warm": loop.warm}, _reference(loop))


def control(loop, precision: str) -> dict:
    """The reference in ``precision`` put in the program's place."""
    return _both({s: reference_run(loop, s, precision) for s in STAGES}, _reference(loop))


def fault(loop, name: str) -> dict:
    """A fault planted in the reference put in the program's place:
    ``half`` (the loss over half of each batch) or ``unchanged`` (the
    steps leave the state as it was)."""
    ref = _reference(loop)
    if name == "unchanged":
        got = {s: dict(r, change={k: 0.0 for k in r["change"]}) for s, r in ref.items()}
        return _both(got, ref)
    return _both({s: reference_run(loop, s, fault=name) for s in STAGES}, ref)
