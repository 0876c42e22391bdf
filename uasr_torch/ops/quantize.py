"""int8 quantization for serving (counterpart of ``uasr.ops.quantize``).

Weight-only int8 (``tools.export --quantize int8``): every large weight
is stored as int8 values with a symmetric per-output-channel f32 scale
and dequantized inside the exported program. Biases, LayerNorm scales
and small weights stay f32.

The leaves quantized are those the JAX package quantizes: flax kernels
(the port's ``weight`` of a Dense, a Conv or a conv block, and the patch
front's ``context_weight``) and the GRU layers' ``wx`` / ``wh``, with at
least ``min_size`` elements and at least two dimensions. JAX's
per-channel axis is flax's last one. In the port's layout
(``uasr_torch.convert``) that is dim 0 of a Dense or conv weight, the
last dim of ``wx`` / ``wh`` (kept in flax's layout), and the dh axis of
an attention query, key or value weight [heads * dh, D], which is
quantized as its [heads, dh, D] view. So quantizing the port's weights
gives ``flax_to_state_dict`` of JAX's quantized kernels.

``int8_compute`` (``model.int8_compute``, ``--quantize int8-compute``):
``int8_linear`` and ``int8_conv1d`` are the Dense and Conv products of
the ``cnn`` and ``classifier`` families as int8 x int8 -> int32 products
(``torch._int_mm``; JAX's XLA ``dot_general`` with
``preferred_element_type=int32``, outside Pallas), exact on the CPU and
on the card: weights re-quantized per output channel (a lossless round
trip of a ``quantize_leaf`` kernel), activations per row for a Dense and
per tensor for a conv, the two scales applied to the f32 result.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F


class QLeaf(NamedTuple):
    """A quantized weight (JAX's ``{"qint8", "qscale"}``): int8 values
    and f32 scales in its per-channel view, and the weight's own shape."""

    qint8: torch.Tensor
    qscale: torch.Tensor
    shape: tuple


def quantize_leaf(w: torch.Tensor, reduce_dims: tuple[int, ...]) -> tuple[torch.Tensor,
                                                                          torch.Tensor]:
    """Symmetric int8 over the channels left by ``reduce_dims``: (q int8,
    scale f32 with the reduced dims kept as 1)."""
    wf = w.float()
    scale = torch.clamp(wf.abs().amax(dim=reduce_dims, keepdim=True), min=1e-12) / 127.0
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_leaf(leaf: QLeaf, dtype=None) -> torch.Tensor:
    w = (leaf.qint8.float() * leaf.qscale).reshape(leaf.shape)
    return w if dtype is None else w.to(dtype)


def _layouts(model: torch.nn.Module) -> dict[str, tuple[int, ...]]:
    """The per-channel view of the attention projections a quantized
    leaf is taken in: ``name -> (heads, dh, D)``."""
    from uasr_torch.models.layers import MultiHeadAttention

    views = {}
    for prefix, m in model.named_modules():
        if isinstance(m, MultiHeadAttention):
            for p in ("query", "key", "value"):
                w = getattr(m, p).weight
                views[f"{prefix}.{p}.weight".lstrip(".")] = (
                    m.num_heads, w.shape[0] // m.num_heads, w.shape[1])
    return views


def _quantizable(name: str) -> bool:
    last = name.rsplit(".", 1)[-1]
    return last in ("weight", "wx", "wh") or last.endswith("_weight")


def quantize_tree(model: torch.nn.Module, params: dict | None = None, min_size: int = 4096):
    """(quantized tree, number of quantized leaves) of ``model``'s
    parameters (or ``params``, a state dict of the model's names): each
    quantizable weight with at least two dimensions and ``min_size``
    elements becomes a ``QLeaf``; the other entries stay as they are."""
    views = _layouts(model)
    params = dict(model.named_parameters()) if params is None else params
    out, count = {}, 0
    for name, w in params.items():
        if (_quantizable(name) and w.ndim >= 2 and w.numel() >= min_size
                and w.is_floating_point()):
            view = views.get(name)
            if view is not None:
                q, s = quantize_leaf(w.detach().reshape(view), (0, 2))
            elif name.rsplit(".", 1)[-1] in ("wx", "wh"):
                q, s = quantize_leaf(w.detach(), tuple(range(w.ndim - 1)))
            else:
                q, s = quantize_leaf(w.detach(), tuple(range(1, w.ndim)))
            out[name] = QLeaf(q, s, tuple(w.shape))
            count += 1
        else:
            out[name] = w
    return out, count


def dequantize_tree(qparams: dict, dtype=None) -> dict:
    """Inverse of ``quantize_tree``: every ``QLeaf`` dequantized (to
    ``dtype`` if given, else f32)."""
    return {k: dequantize_leaf(v, dtype) if isinstance(v, QLeaf) else v
            for k, v in qparams.items()}


def quantized_bytes(qparams: dict) -> tuple[int, int]:
    """(bytes of the quantized tree, bytes of the f32 tree it stands for):
    a leaf's scales count toward the quantized tree only."""
    qb = fb = 0
    for v in qparams.values():
        if isinstance(v, QLeaf):
            qb += v.qint8.numel() + v.qscale.numel() * v.qscale.element_size()
            fb += v.qint8.numel() * 4
        else:
            n = v.numel() * v.element_size()
            qb += n
            fb += n
    return qb, fb


def int8_matmul_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of ``int8_matmul``: a [M, K] @ b [N, K]^T in float64,
    exact for K up to 2^53 / 127^2, as int32."""
    return (a.double() @ b.double().T).to(torch.int32)


def _pad_to(x: torch.Tensor, dim: int, size: int) -> torch.Tensor:
    pad = size - x.shape[dim]
    if pad <= 0:
        return x
    widths = [0, 0] * (x.ndim - 1 - dim) + [0, pad]
    return F.pad(x, widths)


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [M, K] int8 @ b [N, K]^T int8 -> [M, N] int32 by ``torch._int_mm``.

    On CUDA ``_int_mm`` takes only M > 16 and K, N multiples of 8, so the
    operands are zero-padded to M >= 17 rows and K and N to multiples of
    8 (the added zeros add nothing to any sum) and the result is cut back
    to [M, N]; the same padding runs on the CPU."""
    M, K = a.shape
    N = b.shape[0]
    k8, n8 = -(-K // 8) * 8, -(-N // 8) * 8
    ap = _pad_to(_pad_to(a, 1, k8), 0, max(M, 17)).contiguous()
    bp = _pad_to(_pad_to(b, 1, k8), 0, n8).contiguous()
    return torch._int_mm(ap, bp.t())[:M, :N]


def _q8(xf: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)


def int8_linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., I] @ w [O, I]^T on int8 (``int8_dot_general``): w per output
    channel, x per row (per frame), int32 sums, f32 result y * sx * sw."""
    xf, wf = x.float(), w.float()
    sw = torch.clamp(wf.abs().amax(1), min=1e-12) / 127.0  # [O]
    sx = torch.clamp(xf.abs().amax(-1, keepdim=True), min=1e-12) / 127.0  # [..., 1]
    y = int8_matmul(_q8(xf, sx).reshape(-1, x.shape[-1]), _q8(wf, sw[:, None]))
    return y.float().reshape(*x.shape[:-1], w.shape[0]) * sx * sw


def int8_conv1d(x: torch.Tensor, w: torch.Tensor, stride: int, dilation: int,
                pad: tuple[int, int]) -> torch.Tensor:
    """A 1-D conv over time on int8 (``int8_conv_general_dilated``): x [B,
    T, C] padded by ``pad`` (low, high) frames, w [O, C, k]; w per output
    channel, x per tensor (a per-position scale would break the weight
    sharing across taps); im2col and one int32 product, f32 result [B,
    T', O] = y * sx * sw."""
    B, T, C = x.shape
    O, _, k = w.shape
    xf, wf = x.float(), w.float()
    sw = torch.clamp(wf.abs().amax((1, 2)), min=1e-12) / 127.0  # [O]
    sx = torch.clamp(xf.abs().amax(), min=1e-12) / 127.0
    xq = F.pad(_q8(xf, sx), (0, 0) + tuple(pad))
    cols = xq.unfold(1, (k - 1) * dilation + 1, stride)[..., ::dilation]  # [B, T', C, k]
    Tp = cols.shape[1]
    y = int8_matmul(cols.reshape(B * Tp, C * k), _q8(wf, sw[:, None, None]).reshape(O, C * k))
    return y.float().reshape(B, Tp, O) * sx * sw
