"""Building blocks (counterpart of ``uasr.models.layers``): the BiGRU and
the unidirectional GRU layer with reset-after gates, the strided conv
blocks, flax's multi-head attention, and the small parameter holders the
encoders share.

Parameters are float32 and the compute dtype is applied in ``forward``
(flax's ``dtype`` semantics), so a checkpoint converted from the JAX
package (``uasr_torch.convert``) loads unchanged for either dtype.
Initialisation draws only from the ``torch.Generator`` it is given.

Padding-aware: the reversed direction of the BiGRU starts at each
utterance's own last frame, and hidden state stops updating past the
end of each utterance, so results do not depend on batch padding.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from uasr_torch.models.cuda_gru import bigru_scan, bigru_scan_reference, gru_scan
from uasr_torch.ops.attention import dot_product_attention
from uasr_torch.ops.cuda_attention import fused_dot_product_attention


def lecun_normal_(t: torch.Tensor, fan_in: int, generator: torch.Generator) -> torch.Tensor:
    with torch.no_grad():
        return t.copy_(torch.randn(t.shape, generator=generator) / math.sqrt(fan_in))


def lecun_truncated_normal_(t: torch.Tensor, fan_in: int,
                            generator: torch.Generator) -> torch.Tensor:
    """flax's default kernel init (``lecun_normal``: a normal truncated at
    two standard deviations, its scale corrected to variance 1 / fan_in)."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        return torch.nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std,
                                           generator=generator)


def orthogonal_rows(rows: int, cols: int, generator: torch.Generator) -> torch.Tensor:
    """[rows, cols] matrix with orthonormal rows (rows <= cols) or columns."""
    a = torch.randn(max(rows, cols), min(rows, cols), generator=generator, dtype=torch.float64)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))[None, :]
    return (q.T if rows < cols else q).to(torch.float32)


class Dense(nn.Module):
    """y = x @ weight.T + bias in the compute dtype (flax ``nn.Dense``)."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_dim, in_dim))
        self.bias = nn.Parameter(torch.empty(out_dim))

    def reset_parameters(self, generator: torch.Generator) -> None:
        lecun_normal_(self.weight, self.weight.shape[1], generator)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return F.linear(x.to(dtype), self.weight.to(dtype), self.bias.to(dtype))


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm``: statistics and affine in f32 (eps 1e-6),
    output in the input's dtype."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def reset_parameters(self, generator: torch.Generator) -> None:
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), (x.shape[-1],), self.weight, self.bias, self.eps)
        return y.to(x.dtype)


def same_padding(n: int, k: int, s: int) -> tuple[int, int]:
    """(low, high) padding of XLA's "SAME" for input length n."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class Conv1d(nn.Module):
    """flax ``nn.Conv`` over time: [B, T, C_in] -> [B, T', C_out] in the
    compute dtype, "SAME" padding split as XLA splits it (low gets the
    smaller half: lo 1 / hi 2 for a stride-2, kernel-5 conv on an even
    length; (k-1)*d split lo/hi for a stride-1 dilated conv), or no padding
    with ``padding="VALID"``. ``groups`` is flax's ``feature_group_count``
    (``groups = C_in`` makes it depthwise). Weight [out, in / groups, k]."""

    def __init__(self, in_dim: int, out_dim: int, kernel: int, stride: int = 1,
                 dilation: int = 1, groups: int = 1, padding: str = "SAME"):
        super().__init__()
        self.kernel, self.stride, self.dilation = kernel, stride, dilation
        self.groups, self.padding = groups, padding
        self.weight = nn.Parameter(torch.empty(out_dim, in_dim // groups, kernel))
        self.bias = nn.Parameter(torch.empty(out_dim))

    def reset_parameters(self, generator: torch.Generator) -> None:
        lecun_normal_(self.weight, self.weight[0].numel(), generator)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        lo, hi = 0, 0
        if self.padding == "SAME":
            lo, hi = same_padding(x.shape[1], (self.kernel - 1) * self.dilation + 1, self.stride)
        y = F.conv1d(F.pad(x.to(dtype).transpose(1, 2), (lo, hi)), self.weight.to(dtype),
                     self.bias.to(dtype), stride=self.stride, dilation=self.dilation,
                     groups=self.groups)
        return y.transpose(1, 2)


class ConvBlock(nn.Module):
    """Strided 2D conv over (time, freq), "SAME" padding, + LayerNorm over
    channels + ReLU. Input and output [B, T, F, C]."""

    def __init__(self, in_channels: int, channels: int, kernel: int = 3,
                 time_stride: int = 2, freq_stride: int = 2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.kernel, self.strides, self.dtype = kernel, (time_stride, freq_stride), dtype
        self.weight = nn.Parameter(torch.empty(channels, in_channels, kernel, kernel))
        self.bias = nn.Parameter(torch.empty(channels))
        self.norm = LayerNorm(channels)

    def reset_parameters(self, generator: torch.Generator) -> None:
        lecun_normal_(self.weight, self.weight[0].numel(), generator)
        nn.init.zeros_(self.bias)
        self.norm.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        B, T, Fq, _ = x.shape
        xc = x.to(dt).permute(0, 3, 1, 2)  # [B, C, T, F]
        t_lo, t_hi = same_padding(T, self.kernel, self.strides[0])
        f_lo, f_hi = same_padding(Fq, self.kernel, self.strides[1])
        xc = F.pad(xc, (f_lo, f_hi, t_lo, t_hi))
        y = F.conv2d(xc, self.weight.to(dt), self.bias.to(dt), stride=self.strides)
        return F.relu(self.norm(y.permute(0, 2, 3, 1)))


def conv_out_length(lengths, stride: int, num_layers: int):
    for _ in range(num_layers):
        lengths = (lengths + stride - 1) // stride
    return lengths


class BiGRU(nn.Module):
    """Bidirectional GRU over time-major input [T, B, D] -> [T, B, 2H].

    Both directions' input projections are computed in frame order; the
    recurrence runs both streams at once (the reversed stream reads frame
    T-1-u at step u, its first T - len steps masked as padding). With
    ``use_pallas`` the recurrence is ``cuda_gru.bigru_scan``, whose
    forward is kernel K2 and backward kernel K2-bwd for CUDA tensors (their
    plain versions for CPU tensors); otherwise autograd runs through K2's
    plain version.
    Parameters grouped [2, ...]: index 0 = forward, 1 = backward; gate
    order r, z, n (reset-after, cuDNN convention).
    """

    def __init__(self, input_dim: int, hidden: int, dtype: torch.dtype = torch.float32,
                 use_pallas: bool = False):
        super().__init__()
        self.hidden, self.dtype, self.use_pallas = hidden, dtype, use_pallas
        H3 = 3 * hidden
        self.wx = nn.Parameter(torch.empty(2, input_dim, H3))
        self.wh = nn.Parameter(torch.empty(2, hidden, H3))
        self.bx = nn.Parameter(torch.empty(2, H3))
        self.bh = nn.Parameter(torch.empty(2, H3))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            for g in range(2):
                lecun_normal_(self.wx[g], self.wx.shape[1], generator)
                self.wh[g].copy_(orthogonal_rows(self.hidden, 3 * self.hidden, generator))
        nn.init.zeros_(self.bx)
        nn.init.zeros_(self.bh)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        T, B, _ = x.shape
        dt = self.dtype
        x = x.to(dt)
        wx, wh, bx, bh = (p.to(dt) for p in (self.wx, self.wh, self.bx, self.bh))
        tpos = torch.arange(T, device=x.device)[:, None]
        tmask = torch.stack([tpos < lengths[None, :], tpos >= (T - lengths)[None, :]],
                            dim=1)  # [T, 2, B] in kernel time
        p0 = x @ wx[0] + bx[0]
        p1 = x @ wx[1] + bx[1]
        scan = bigru_scan if self.use_pallas else bigru_scan_reference
        out = scan(p0.contiguous(), p1.contiguous(), wh.contiguous(), bh.contiguous(), tmask)
        valid = (tpos < lengths[None, :])[..., None]
        # stays in the compute dtype; consumers cast as they need
        return torch.where(valid, out, 0.0)


class GRULayer(nn.Module):
    """Unidirectional GRU over batch-major input [B, T, D] -> [B, T, H]
    (``uasr.models.layers.GRULayer``), reset-after gates r, z, n.

    ``lengths`` freezes the carried state past each utterance's end, and
    output frames there are zero (f32). ``reverse`` runs right to left
    within each utterance's own length. The input projections of all
    steps are one product, in the compute dtype.

    With ``use_pallas`` and no ``h0`` the recurrence is
    ``cuda_gru.gru_scan`` with one group: kernel K5 forward and K5-bwd (or
    K8, with ``UASR_GRU_BWD_IMPL=linear``) backward for CUDA tensors, their
    plain versions for CPU tensors (f32 gates), and the final state is the
    last step's output, which is frozen past each utterance's end. With an
    ``h0`` (a streaming chunk) the recurrence is the plain step loop of
    the JAX package's ``lax.scan`` branch, gates in ``dtype``: the TPU
    kernel has no initial-state input, so the JAX package takes this
    branch there too; it is that package's own path, not a fallback.
    Without ``use_pallas`` the same step loop runs from zero.
    ``return_final`` also returns the state after the last step, the
    carry of the next chunk. Parameters ``wx [D, 3H]``, ``wh [H, 3H]``,
    ``bx``, ``bh [3H]``, flax's."""

    def __init__(self, input_dim: int, hidden: int, reverse: bool = False,
                 dtype: torch.dtype = torch.float32, use_pallas: bool = False):
        super().__init__()
        self.hidden, self.reverse, self.dtype, self.use_pallas = hidden, reverse, dtype, use_pallas
        self.wx = nn.Parameter(torch.empty(input_dim, 3 * hidden))
        self.wh = nn.Parameter(torch.empty(hidden, 3 * hidden))
        self.bx = nn.Parameter(torch.empty(3 * hidden))
        self.bh = nn.Parameter(torch.empty(3 * hidden))

    def reset_parameters(self, generator: torch.Generator) -> None:
        lecun_normal_(self.wx, self.wx.shape[0], generator)
        with torch.no_grad():
            self.wh.copy_(orthogonal_rows(self.hidden, 3 * self.hidden, generator))
        nn.init.zeros_(self.bx)
        nn.init.zeros_(self.bh)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor, h0: torch.Tensor | None = None,
                return_final: bool = False):
        B, T, D = x.shape
        H, dt = self.hidden, self.dtype
        x = x.to(dt)
        wx, wh, bx, bh = (p.to(dt) for p in (self.wx, self.wh, self.bx, self.bh))
        tpos = torch.arange(T, device=x.device)
        if self.reverse:
            # reverse within each utterance's valid length
            idx = torch.clamp(lengths[:, None] - 1 - tpos[None, :], 0, T - 1)
            x = x.gather(1, idx[..., None].expand(B, T, D))
        xproj = (x.reshape(B * T, D) @ wx + bx).reshape(B, T, 3 * H).transpose(0, 1)
        tmask = tpos[:, None] < lengths[None, :]  # [T, B]
        if h0 is not None and self.reverse:
            raise ValueError("GRULayer h0 carry is a forward-scan feature (streaming); "
                             "unsupported with reverse=True")
        if self.use_pallas and h0 is None:
            ys = gru_scan(xproj[:, None].contiguous(), wh[None].contiguous(),
                          bh[None].contiguous(), tmask[:, None])[:, 0]
            h_final = ys[-1]  # pre-mask emit = frozen state past ends
        else:
            h = torch.zeros(B, H, dtype=dt, device=x.device) if h0 is None else h0.to(dt)
            steps = []
            for t in range(T):
                hproj = h @ wh + bh
                xr, xz, xn = xproj[t].split(H, -1)
                hr, hz, hn = hproj.split(H, -1)
                r = torch.sigmoid(xr + hr)
                z = torch.sigmoid(xz + hz)
                n = torch.tanh(xn + r * hn)  # reset-after (cuDNN convention)
                h = torch.where(tmask[t][:, None], (1.0 - z) * n + z * h, h)
                steps.append(h)
            ys = torch.stack(steps) if steps else xproj.new_zeros(0, B, H)
            h_final = h
        ys = ys.transpose(0, 1)  # [B, T, H]
        if self.reverse:
            ys = ys.gather(1, idx[..., None].expand(B, T, H))
        valid = (tpos[None, :] < lengths[:, None])[..., None]
        out = torch.where(valid, ys, 0.0).to(torch.float32)
        if return_final:
            return out, h_final
        return out


class MultiHeadAttention(nn.Module):
    """flax ``nn.MultiHeadDotProductAttention`` for self-attention:
    ``query``/``key``/``value`` projections to [B, T, heads * dh] plus bias,
    attention over heads, ``out`` projection back to D plus bias, all in
    the compute dtype. Q, K and V stay packed [B, T, heads * dh] (viewed as
    [B, T, heads, dh]), the layout kernel K6 takes. ``attn_pallas`` picks
    ``fused_dot_product_attention`` (K6 forward and K6-bwd backward for
    CUDA tensors, their plain versions for CPU tensors), else
    ``dot_product_attention`` (flax's).
    ``dropout`` drops attention weights in ``train()`` mode."""

    def __init__(self, dim: int, num_heads: int, dtype: torch.dtype = torch.float32,
                 attn_pallas: bool = False, dropout: float = 0.0):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"hidden size {dim} is not a multiple of num_heads {num_heads}")
        self.num_heads, self.dtype, self.attn_pallas, self.dropout = (num_heads, dtype,
                                                                      attn_pallas, dropout)
        # flax's DenseGeneral kernels [D, heads, dh] and [heads, dh, D],
        # flattened to Dense
        self.query, self.key, self.value, self.out = (Dense(dim, dim) for _ in range(4))

    def reset_parameters(self, generator: torch.Generator) -> None:
        for p in (self.query, self.key, self.value, self.out):
            p.reset_parameters(generator)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None,
                bias: torch.Tensor | None = None) -> torch.Tensor:
        B, T, D = x.shape
        dt, H = self.dtype, self.num_heads
        q, k, v = (p(x, dt).view(B, T, H, D // H) for p in (self.query, self.key, self.value))
        attn = fused_dot_product_attention if self.attn_pallas else dot_product_attention
        o = attn(q, k, v, bias=bias, mask=mask, dropout_rate=self.dropout,
                 deterministic=not self.training)
        return self.out(o.reshape(B, T, D), dt)
