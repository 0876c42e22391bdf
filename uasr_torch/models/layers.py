"""Building blocks (counterpart of ``uasr.models.layers``): the BiGRU with
reset-after gates, the strided conv block, and the small parameter
holders the encoders share.

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

from uasr_torch.models.cuda_gru import bigru_scan, bigru_scan_reference


def lecun_normal_(t: torch.Tensor, fan_in: int, generator: torch.Generator) -> torch.Tensor:
    with torch.no_grad():
        return t.copy_(torch.randn(t.shape, generator=generator) / math.sqrt(fan_in))


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
    ``use_pallas`` and CUDA tensors the recurrence is kernel K2
    (``cuda_gru.bigru_scan``); otherwise it is K2's plain version.
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
