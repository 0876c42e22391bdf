"""The two encoders, plain PyTorch over a dict of float32 weights.

``conv_bigru``: ``num_conv_layers`` Conv2D blocks over (time, frequency),
kernel k, stride 2 on both axes, "SAME" padding as XLA splits it (the low
side gets the smaller half), bias, LayerNorm over channels (eps 1e-6),
ReLU, frames past the block's length zeroed; the [T', F', C] map flattened
frequency-major; then ``num_gru_layers`` bidirectional GRUs (reset-after
gates r, z, n: n = tanh(x_n + r (h W_hn + b_hn)); h' = (1 - z) n + z h),
the backward direction running from each utterance's last valid frame
with a zero state; a dense layer to the vocabulary.

``cnn``: Conv1d (stride ``conv_time_stride``) and ``num_conv_layers - 1``
unstrided Conv1d, each followed by LayerNorm and ReLU, then two residual
Conv1d blocks dilated 2 and 4 (x + ReLU(LN(conv(x)))), frames past the
length zeroed after every block, and a dense layer; logits past the length
are zero.

Weights use the names and layouts of the state dicts the benchmark draws:
``conv{i}.weight`` [out, in, k(, k)], ``conv{i}.norm.*`` (conv_bigru) or
``norm{i}.*`` (cnn), ``bigru{i}.wx`` [2, in, 3H], ``.wh`` [2, H, 3H], ``.bx``,
``.bh`` [2, 3H], ``logits.weight`` [V, in], ``logits.bias``. ``cast``
rounds every product's operands (the control).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.precision import Cast


def same_padding(n: int, k: int, s: int) -> tuple[int, int]:
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _mask(T: int, lengths: torch.Tensor) -> torch.Tensor:
    return torch.arange(T, device=lengths.device)[None, :] < lengths[:, None]


def _ln(x, w, b):
    return F.layer_norm(x, (x.shape[-1],), w, b, 1e-6)


def conv_front(W: dict, m: dict, feats: torch.Tensor, lengths: torch.Tensor, cast: Cast):
    x = feats[..., None]  # [B, T, F, 1]
    k = m["conv_kernel"]
    for i in range(m["num_conv_layers"]):
        B, T, Fq, _ = x.shape
        xc = x.permute(0, 3, 1, 2)
        t_lo, t_hi = same_padding(T, k, m["conv_time_stride"])
        f_lo, f_hi = same_padding(Fq, k, 2)
        xc = F.pad(xc, (f_lo, f_hi, t_lo, t_hi))
        y = F.conv2d(cast(xc), cast(W[f"conv{i}.weight"]), W[f"conv{i}.bias"],
                     stride=(m["conv_time_stride"], 2)).permute(0, 2, 3, 1)
        x = F.relu(_ln(y, W[f"conv{i}.norm.weight"], W[f"conv{i}.norm.bias"]))
        s = m["conv_time_stride"]
        lengths = torch.div(lengths + s - 1, s, rounding_mode="floor").clamp(max=x.shape[1])
        x = x * _mask(x.shape[1], lengths)[..., None, None]
    B, T2, F2, C = x.shape
    return x.reshape(B, T2, F2 * C), lengths


def bigru(W: dict, name: str, x: torch.Tensor, lengths: torch.Tensor, cast: Cast):
    """[B, T, D] -> [B, T, 2H], zero past each length."""
    B, T, _ = x.shape
    wx, wh, bx, bh = (W[f"{name}.{p}"] for p in ("wx", "wh", "bx", "bh"))
    H = wh.shape[1]
    proj = torch.stack([cast(x) @ cast(wx[g]) + bx[g] for g in range(2)])  # [2, B, T, 3H]
    valid = _mask(T, lengths).T  # [T, B]
    h = x.new_zeros(2, B, H)
    wh_c = cast(wh)
    outs_f, outs_b = [], [None] * T
    for u in range(T):
        t_b = T - 1 - u
        xp = torch.stack([proj[0, :, u], proj[1, :, t_b]])  # [2, B, 3H]
        hp = torch.bmm(cast(h), wh_c) + bh[:, None, :]
        xr, xz, xn = xp.split(H, -1)
        hr, hz, hn = hp.split(H, -1)
        r, z = torch.sigmoid(xr + hr), torch.sigmoid(xz + hz)
        cand = (1.0 - z) * torch.tanh(xn + r * hn) + z * h
        live = torch.stack([valid[u], valid[t_b]])[..., None]
        h = torch.where(live, cand, h)
        outs_f.append(torch.where(live[0], h[0], 0.0))
        outs_b[t_b] = torch.where(live[1], h[1], 0.0)
    return torch.cat([torch.stack(outs_f, 1), torch.stack(outs_b, 1)], -1)


def dense(W: dict, name: str, x: torch.Tensor, cast: Cast) -> torch.Tensor:
    return cast(x) @ cast(W[f"{name}.weight"]).T + W[f"{name}.bias"]


def conv_bigru(W: dict, m: dict, feats: torch.Tensor, lengths: torch.Tensor,
               cast: Cast | None = None):
    """features [B, T, D] -> (logits [B, T', V], lengths [B])."""
    cast = cast or Cast()
    x, lengths = conv_front(W, m, feats, lengths, cast)
    for i in range(m["num_gru_layers"]):
        x = bigru(W, f"bigru{i}", x, lengths, cast)
    return dense(W, "logits", x, cast), lengths


def _conv1d(W, name, x, k, stride, dilation, cast):
    lo, hi = same_padding(x.shape[1], (k - 1) * dilation + 1, stride)
    y = F.conv1d(F.pad(cast(x).transpose(1, 2), (lo, hi)), cast(W[f"{name}.weight"]),
                 W[f"{name}.bias"], stride=stride, dilation=dilation)
    return y.transpose(1, 2)


def cnn(W: dict, m: dict, feats: torch.Tensor, lengths: torch.Tensor, cast: Cast | None = None):
    """features [B, T, D] -> (logits [B, T', V], lengths [B])."""
    cast = cast or Cast()
    k, n_conv = m["conv_kernel"], max(m["num_conv_layers"], 1)
    x = feats * _mask(feats.shape[1], lengths)[..., None]
    for i in range(n_conv):
        s = m["conv_time_stride"] if i == 0 else 1
        x = F.relu(_ln(_conv1d(W, f"conv{i}", x, k, s, 1, cast), W[f"norm{i}.weight"],
                       W[f"norm{i}.bias"]))
        if s > 1:
            lengths = torch.div(lengths + s - 1, s, rounding_mode="floor").clamp(max=x.shape[1])
        x = x * _mask(x.shape[1], lengths)[..., None]
    for i in range(2):
        j = n_conv + i
        y = _ln(_conv1d(W, f"dil{i}", x, k, 1, 2 ** (i + 1), cast), W[f"norm{j}.weight"],
                W[f"norm{j}.bias"])
        x = (x + F.relu(y)) * _mask(x.shape[1], lengths)[..., None]
    logits = dense(W, "logits", x, cast)
    return logits * _mask(logits.shape[1], lengths)[..., None], lengths


ENCODERS = {"conv_bigru": conv_bigru, "cnn": cnn}


def encode(W: dict, m: dict, feats, lengths, cast: Cast | None = None):
    if m["encoder"] not in ENCODERS:
        raise ValueError(f"the reference has no encoder {m['encoder']!r}")
    return ENCODERS[m["encoder"]](W, m, feats, lengths, cast)
