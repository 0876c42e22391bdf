"""Plain multi-head dot-product attention: the counterpart of flax's
``nn.dot_product_attention``, which the JAX package's attention encoders
call when ``model.attn_pallas`` is off, and which the fused wrapper
(``ops/cuda_attention.py``) hands the cases its kernel does not take
(active dropout, masks other than key-only, per-example biases), as the
JAX wrapper hands them to flax.

Layout [B, T, heads, dh], flax's. As flax computes it in the compute
dtype: the query is divided by sqrt(dh) before the product, the bias is
added to the scores, masked scores become the dtype's lowest value, the
softmax (run in f32 here) is cast back to the dtype, and the weights are
normalised before the product with V.
"""

from __future__ import annotations

import math

import torch


def dot_product_attention(query, key, value, bias=None, mask=None, dropout_rate: float = 0.0,
                          deterministic: bool = True, generator: torch.Generator | None = None):
    """query/key/value [B, T, H, dh] (key/value may have another length);
    bias broadcastable to [B, H, Tq, Tk]; mask bool, broadcastable to the
    same (True = attend). Dropout on the weights (one mask shared by the
    batch and heads, as flax's ``broadcast_dropout``) only when
    ``dropout_rate > 0`` and not ``deterministic``. Returns [B, Tq, H, dh]."""
    dtype = query.dtype
    depth = query.shape[-1]
    query = query / torch.tensor(math.sqrt(depth), dtype=torch.float32).to(dtype)
    w = torch.einsum("bqhd,bkhd->bhqk", query, key.to(dtype))
    if bias is not None:
        w = w + bias
    if mask is not None:
        w = torch.where(mask, w, torch.finfo(dtype).min)
    w = torch.softmax(w.float(), -1).to(dtype)
    if dropout_rate > 0.0 and not deterministic:
        keep_prob = 1.0 - dropout_rate
        keep = torch.rand(w.shape[-2:], generator=generator, device=w.device) < keep_prob
        w = w * (keep.to(dtype) / torch.tensor(keep_prob, dtype=dtype))
    return torch.einsum("bhqk,bkhd->bqhd", w, value.to(dtype))
