"""Weights drawn from the seed on the device, in one call.

One standard-normal draw from a ``torch.Generator`` on the device covers
every random leaf; each leaf is scaled by 1 / sqrt(fan-in) (LeCun normal).
Biases (``*.bias``, ``*.bx``, ``*.bh``) are 0 and LayerNorm scales
(``*norm*.weight``) 1. A GRU's ``wx`` / ``wh`` [2, in, 3H] have fan-in
``in``; every other matrix or kernel [out, ...] has fan-in numel / out.
From the configuration's ``weights``: ``logits_gain`` scales the output
layer's weight, and the blank's row of it is zero; ``blank_bias``
then sets the blank's bias so that a character wins on ``emit_share`` of
the frames of a probe batch under the plain reference (random weights
otherwise emit a character on nearly every frame, a trained CTC model on
few, and a fixed bias would emit at a rate that changes with the seed).
The same tensors are loaded into the program and handed to the reference.
"""

from __future__ import annotations

import math

import torch


def _kind(name: str, shape: tuple) -> str:
    leaf = name.rsplit(".", 1)[-1]
    if leaf in ("bias", "bx", "bh"):
        return "zero"
    if "norm" in name and leaf == "weight":
        return "one"
    if len(shape) < 2:
        raise ValueError(f"no rule for the 1-d leaf {name} {shape}")
    return "random"


def fan_in(name: str, shape: tuple) -> int:
    if name.rsplit(".", 1)[-1] in ("wx", "wh"):
        return shape[1]
    return math.prod(shape) // shape[0]


def draw(shapes: dict, seed: int, device, rules: dict | None = None) -> dict:
    """{name: shape} -> {name: float32 tensor on ``device``}."""
    rules = rules or {}
    rand = [k for k, s in shapes.items() if _kind(k, s) == "random"]
    total = sum(math.prod(shapes[k]) for k in rand)
    g = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(total, generator=g, device=device)
    out, off = {}, 0
    for k, s in shapes.items():
        kind = _kind(k, s)
        if kind == "random":
            n = math.prod(s)
            out[k] = flat[off:off + n].view(s) / math.sqrt(fan_in(k, s))
            off += n
        else:
            out[k] = (torch.ones if kind == "one" else torch.zeros)(s, device=device)
    if "logits_gain" in rules:
        out["logits.weight"] *= rules["logits_gain"]
    if "emit_share" in rules:
        out["logits.weight"][rules.get("blank_id", 0)] = 0.0
    return out


@torch.no_grad()
def blank_bias(W: dict, conf: dict, audio: torch.Tensor, lengths: torch.Tensor) -> None:
    """Set the blank's output bias in ``W`` to the (1 - emit_share)
    quantile, over the probe's valid frames, of the best character's logit
    minus the blank's, computed by the plain reference in float32."""
    from benchmark.reference.fbank import Fbank
    from benchmark.reference.models import encode
    from benchmark.reference.precision import no_tf32

    rules, fe = conf["weights"], conf["recipe"]["frontend"]
    blank = rules.get("blank_id", 0)
    W["logits.bias"][blank] = 0.0
    with no_tf32():
        fb = Fbank(fe, audio.device)
        feats, flen = (fb.streaming if fe.get("cmvn") == "streaming" else fb.utterance)(
            audio, lengths)
        logits, n = encode(W, conf["recipe"]["model"], feats, flen)
    valid = torch.arange(logits.shape[1], device=n.device)[None, :] < n[:, None]
    chars = logits.clone()
    chars[..., blank] = -torch.inf
    margin = (chars.amax(-1) - logits[..., blank])[valid].float()
    W["logits.bias"][blank] = float(margin.sort().values[int((1 - rules["emit_share"])
                                                             * (margin.numel() - 1))])


@torch.no_grad()
def load_into(module: torch.nn.Module, weights: dict) -> None:
    """Copy ``weights`` into the module's parameters, every one of them."""
    params = dict(module.named_parameters())
    if set(params) != set(weights):
        raise ValueError(f"weights and model differ: {sorted(set(params) ^ set(weights))}")
    for k, p in params.items():
        p.copy_(weights[k])
