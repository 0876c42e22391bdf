"""Encoder families (counterpart of ``uasr.models.models``).

- ``ConvBiGRUEncoder``: conv or patch subsampling front -> N x BiGRU ->
  f32 dense logits incl. blank, the supervised CTC acoustic model;
- ``CNNEncoder``: strided conv, dilated residual stack, f32 dense logits,
  the streaming recipe's encoder;
- ``UniGRUEncoder`` and ``LCBiGRUEncoder``: the causal recurrent encoders
  (patch embed, carried-tail context conv, GRU layers through kernel K5,
  trained through K5-bwd or K8) with their streaming ``step`` and initial
  carries;
- ``TransformerEncoder`` and ``ConformerEncoder``: the attention encoders
  (multi-head self-attention through kernels K6 and K6-bwd with
  ``attn_pallas``);
- ``PhoneClassifier``: the unsupervised generator (context conv + MLP,
  f32 dense logits), built by ``build_model("classifier")``; it and the
  critic draw their kernels as flax's default init does (truncated lecun
  normal), the other encoders from an untruncated normal;
- ``PhoneDiscriminator``: the GAN critic over phone distributions,
  always f32 (a bf16 critic overflows under the gradient penalty's
  double backward), built by ``build_discriminator``.

All encoders take (features [B, T, D], lengths [B]) and return
(logits [B, T', V], lengths [B]). ``model.dropout`` acts in ``train()``
mode only (after each BiGRU; on the attention weights and after each
transformer FFN); ``build_model`` returns the model in ``eval()`` mode and
the trainer switches it. ``model.sequence_shard`` constrains a device
mesh in the JAX package and does nothing without one, as here (one
device).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from uasr_torch import resolve_device
from uasr_torch.config import ModelConfig
from uasr_torch.models.layers import (
    BiGRU, Conv1d, ConvBlock, Dense, GRULayer, LayerNorm, MultiHeadAttention, conv_out_length,
    lecun_normal_, lecun_truncated_normal_, same_padding,
)


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _length_mask(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    T = x.shape[1]
    return (torch.arange(T, device=x.device)[None, :] < lengths[:, None])[..., None]


class PatchFront(nn.Module):
    """Non-overlapping patches of ``patch`` frames -> one dense embed ->
    k-wide context conv1d with a residual, LayerNorm + ReLU after each."""

    def __init__(self, in_dim: int, patch: int, hidden: int, kernel: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.patch, self.kernel, self.dtype = patch, kernel, dtype
        self.embed = Dense(patch * in_dim, hidden)
        self.norm0 = LayerNorm(hidden)
        self.context_weight = nn.Parameter(torch.empty(hidden, hidden, kernel))
        self.context_bias = nn.Parameter(torch.empty(hidden))
        self.norm1 = LayerNorm(hidden)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.embed.reset_parameters(generator)
        lecun_normal_(self.context_weight, self.context_weight[0].numel(), generator)
        nn.init.zeros_(self.context_bias)
        self.norm0.reset_parameters(generator)
        self.norm1.reset_parameters(generator)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor):
        B, T, D = x.shape
        P, dt = self.patch, self.dtype
        x = x.to(dt) * _length_mask(x, lengths)
        if T % P:
            x = F.pad(x, (0, 0, 0, P - T % P))
        x = x.reshape(B, x.shape[1] // P, P * D)
        lengths = (lengths + P - 1) // P
        x = F.relu(self.norm0(self.embed(x, dt)))
        x = x * _length_mask(x, lengths)
        lo, hi = same_padding(x.shape[1], self.kernel, 1)
        y = F.conv1d(F.pad(x.transpose(1, 2), (lo, hi)), self.context_weight.to(dt),
                     self.context_bias.to(dt)).transpose(1, 2)
        x = x + F.relu(self.norm1(y))  # residual context block
        return x * _length_mask(x, lengths), lengths


def _front_width(cfg: ModelConfig, in_dim: int) -> int:
    return cfg.conv_channels * (
        (in_dim + 2 ** cfg.num_conv_layers - 1) // 2 ** cfg.num_conv_layers
    )


def _make_front(cfg: ModelConfig, in_dim: int, dt: torch.dtype) -> dict[str, nn.Module]:
    if cfg.conv_front == "patch":
        return {"patch": PatchFront(in_dim, cfg.conv_time_stride ** cfg.num_conv_layers,
                                    _front_width(cfg, in_dim), cfg.conv_kernel, dt)}
    if cfg.conv_front != "conv2d":
        raise ValueError(f"unknown conv_front {cfg.conv_front!r}")
    return {
        f"conv{i}": ConvBlock(1 if i == 0 else cfg.conv_channels, cfg.conv_channels,
                              kernel=cfg.conv_kernel, time_stride=cfg.conv_time_stride,
                              freq_stride=2, dtype=dt)
        for i in range(cfg.num_conv_layers)
    }


def _subsample_front(cfg: ModelConfig, front: list[nn.Module], feats: torch.Tensor,
                     lengths: torch.Tensor, dt: torch.dtype):
    """Shared subsampling front: strided Conv2D blocks (``conv2d``) or the
    patch embed (``patch``). Both emit [B, T/stride**layers, width] with
    width = conv_channels * ceil(D / 2**layers)."""
    if cfg.conv_front == "patch":
        return front[0](feats, lengths)
    x = feats[..., None].to(dt)  # [B, T, D, 1]
    for block in front:
        x = block(x)
        lengths = torch.clamp(conv_out_length(lengths, cfg.conv_time_stride, 1),
                              max=x.shape[1])
        # re-mask each block: bias/LayerNorm make padding frames nonzero
        # and the next strided conv would leak them inward
        x = x * _length_mask(x, lengths)[..., None]
    B, T2, F2, C = x.shape
    return x.reshape(B, T2, F2 * C), lengths


class ConvBiGRUEncoder(nn.Module):
    """conv x N (strided) -> BiGRU x M -> dense logits (V incl. blank)."""

    def __init__(self, cfg: ModelConfig, vocab_size: int, input_dim: int):
        super().__init__()
        self.cfg = cfg
        dt = _dtype(cfg)
        self.front_names = []
        for name, mod in _make_front(cfg, input_dim, dt).items():
            self.add_module(name, mod)
            self.front_names.append(name)
        width = _front_width(cfg, input_dim)
        for i in range(cfg.num_gru_layers):
            d = width if i == 0 else 2 * cfg.hidden_size
            self.add_module(f"bigru{i}", BiGRU(d, cfg.hidden_size, dtype=dt,
                                              use_pallas=cfg.gru_pallas))
        self.logits = Dense(2 * cfg.hidden_size, vocab_size)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for mod in self.children():
            mod.reset_parameters(generator)

    def forward(self, feats: torch.Tensor, lengths: torch.Tensor):
        cfg = self.cfg
        front = [getattr(self, n) for n in self.front_names]
        x, lengths = _subsample_front(cfg, front, feats, lengths, _dtype(cfg))
        # time-major trunk: the BiGRU stack and the logits product run in
        # [T, B, .]
        x = x.transpose(0, 1)
        for i in range(cfg.num_gru_layers):
            x = getattr(self, f"bigru{i}")(x, lengths)
            if cfg.dropout > 0:
                x = F.dropout(x, cfg.dropout, self.training)
        logits = self.logits(x, torch.float32)
        return logits.transpose(0, 1), lengths


class CNNEncoder(nn.Module):
    """Pure-CNN CTC encoder: ``num_conv_layers`` convs over time (the first
    strided by ``conv_time_stride``), a 2-layer residual stack dilated 2
    and 4, LayerNorm (eps 1e-6) + ReLU after each conv, f32 dense logits.
    Padding frames are zeroed after every block, so results do not depend
    on batch padding. ``norm{i}`` follow flax's ``LayerNorm_{i}`` in
    creation order: the convs', then the dilated stack's."""

    def __init__(self, cfg: ModelConfig, vocab_size: int, input_dim: int):
        super().__init__()
        if cfg.int8_compute:
            raise NotImplementedError(
                "model.int8_compute (int8 tensor-core GEMMs) is not ported yet "
                "(ROADMAP.md Queue 1, slice 5: quantize and export)")
        self.cfg = cfg
        H, k = cfg.hidden_size, cfg.conv_kernel
        self.n_conv = max(cfg.num_conv_layers, 1)
        for i in range(self.n_conv):
            self.add_module(f"conv{i}", Conv1d(input_dim if i == 0 else H, H, k,
                                               stride=cfg.conv_time_stride if i == 0 else 1))
        for i in range(2):
            self.add_module(f"dil{i}", Conv1d(H, H, k, dilation=2 ** (i + 1)))
        for i in range(self.n_conv + 2):
            self.add_module(f"norm{i}", LayerNorm(H))
        self.logits = Dense(H, vocab_size)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for mod in self.children():
            mod.reset_parameters(generator)

    def forward(self, feats: torch.Tensor, lengths: torch.Tensor):
        dt = _dtype(self.cfg)
        x = feats.to(dt) * _length_mask(feats, lengths)
        for i in range(self.n_conv):
            conv = getattr(self, f"conv{i}")
            x = F.relu(getattr(self, f"norm{i}")(conv(x, dt)))
            if conv.stride > 1:
                lengths = torch.clamp(conv_out_length(lengths, conv.stride, 1), max=x.shape[1])
            x = x * _length_mask(x, lengths)
        for i in range(2):
            y = getattr(self, f"norm{self.n_conv + i}")(getattr(self, f"dil{i}")(x, dt))
            x = (x + F.relu(y)) * _length_mask(x, lengths)  # residual dilated stack
        logits = self.logits(x, torch.float32)
        return logits * _length_mask(logits, lengths), lengths


_OPEN = 1 << 30  # patch cap of an open-ended stream (int32-safe, as the JAX package's)


class _CausalBase(nn.Module):
    """The causal patch front the recurrent encoders share: non-overlapping
    patches of ``conv_time_stride ** num_conv_layers`` frames -> ``embed``
    + ``embed_ln`` + ReLU -> VALID ``context`` conv of ``conv_kernel``
    patches over the carried tail (the zero tail IS the causal left pad) +
    ``context_ln`` + ReLU, with a residual; flax's names."""

    def __init__(self, cfg: ModelConfig, input_dim: int):
        super().__init__()
        H = cfg.hidden_size
        self.cfg = cfg
        self.patch = cfg.conv_time_stride ** cfg.num_conv_layers
        self.embed = Dense(self.patch * input_dim, H)
        self.embed_ln = LayerNorm(H)
        self.context = Conv1d(H, H, cfg.conv_kernel, padding="VALID")
        self.context_ln = LayerNorm(H)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for mod in self.children():
            mod.reset_parameters(generator)

    def _zero_tail(self, batch: int, device) -> torch.Tensor:
        cfg = self.cfg
        return torch.zeros(batch, cfg.conv_kernel - 1, cfg.hidden_size, dtype=_dtype(cfg),
                           device=device)

    def _front(self, feats: torch.Tensor, frame_valid: torch.Tensor, tail: torch.Tensor):
        """feats [B, C, D], frame_valid [B] valid frames of this span,
        tail [B, kernel - 1, H]. Returns (e [B, C / patch, H], patch
        lengths, new tail)."""
        B, C, D = feats.shape
        P, dt = self.patch, _dtype(self.cfg)
        x = feats.to(dt) * _length_mask(feats, frame_valid)
        if C % P:  # offline callers may pass any T; chunks are aligned
            x = F.pad(x, (0, 0, 0, P - C % P))
        x = x.reshape(B, x.shape[1] // P, P * D)
        pvalid = (frame_valid + P - 1) // P
        e = F.relu(self.embed_ln(self.embed(x, dt)))
        cat = torch.cat([tail.to(dt), e], 1)
        y = F.relu(self.context_ln(self.context(cat, dt)))
        new_tail = cat[:, cat.shape[1] - (self.cfg.conv_kernel - 1):]
        return e + y, pvalid, new_tail


class UniGRUEncoder(_CausalBase):
    """Causal streaming CTC encoder (``model.encoder: uni_gru``): causal
    patch front -> N x unidirectional GRU -> f32 dense logits. The offline
    call IS one streaming ``step`` from the zero state, so chunked serving
    reproduces offline inference. Offline, each GRU runs K5 (with
    ``gru_pallas``); a streaming step carries each layer's state as ``h0``
    and runs the plain step loop, as the JAX package does."""

    def __init__(self, cfg: ModelConfig, vocab_size: int, input_dim: int):
        super().__init__(cfg, input_dim)
        dt, H = _dtype(cfg), cfg.hidden_size
        for i in range(cfg.num_gru_layers):
            self.add_module(f"gru{i}", GRULayer(H, H, dtype=dt, use_pallas=cfg.gru_pallas))
        self.logits = Dense(H, vocab_size)

    def _trunk(self, feats, frame_valid, carry):
        """Shared offline/streaming body; ``carry`` None (offline: zero
        state, K5 allowed) or (ctx_tail, h [L, B, H])."""
        cfg = self.cfg
        tail = self._zero_tail(feats.shape[0], feats.device) if carry is None else carry[0]
        x, pvalid, new_tail = self._front(feats, frame_valid, tail)
        hs = []
        for i in range(cfg.num_gru_layers):
            gru = getattr(self, f"gru{i}")
            if carry is None:
                x = gru(x, pvalid)
            else:
                x, h_i = gru(x, pvalid, h0=carry[1][i], return_final=True)
                hs.append(h_i)
        logits = self.logits(x, torch.float32)
        logits = logits * _length_mask(logits, pvalid)
        new_carry = None if carry is None else (new_tail, torch.stack(hs))
        return logits, pvalid, new_carry

    def forward(self, feats: torch.Tensor, lengths: torch.Tensor):
        logits, plens, _ = self._trunk(feats, lengths, None)
        return logits, plens

    def step(self, feats: torch.Tensor, frame_valid: torch.Tensor, carry):
        """One streaming chunk: feats [B, C, D] (C % patch == 0),
        frame_valid [B] in [0, C], carry from ``uni_gru_initial_carry`` or
        a prior step. Returns (logits [B, C / patch, V], new carry)."""
        logits, _, new_carry = self._trunk(feats, frame_valid, carry)
        return logits, new_carry


class LCBiGRUEncoder(_CausalBase):
    """Latency-controlled BiGRU (``model.encoder: lc_bigru``): causal patch
    front -> N layers of [forward GRU || window-bounded backward GRU] ->
    f32 dense logits. The backward GRU runs right to left over the windows
    [c Nc, c Nc + Nc + Nr) from a zero state (Nc = ``lc_chunk``,
    Nr = ``lc_lookahead`` patches), folded into the batch, so offline and
    streaming compute the same function. Offline, both directions run K5
    (with ``gru_pallas``); a streaming ``step`` runs K5 for each layer's
    backward window and carries the forward state as ``h0`` through the
    plain step loop. Emissions lag ``num_gru_layers`` chunks."""

    def __init__(self, cfg: ModelConfig, vocab_size: int, input_dim: int):
        if cfg.lc_lookahead > cfg.lc_chunk:
            raise ValueError(
                "lc_lookahead must be <= lc_chunk (each backward window's lookahead comes from "
                f"the single next chunk): got {cfg.lc_lookahead} > {cfg.lc_chunk}")
        super().__init__(cfg, input_dim)
        dt, H = _dtype(cfg), cfg.hidden_size
        for i in range(cfg.num_gru_layers):
            d = H if i == 0 else 2 * H
            self.add_module(f"fwd{i}", GRULayer(d, H, dtype=dt, use_pallas=cfg.gru_pallas))
            self.add_module(f"bwd{i}", GRULayer(d, H, reverse=True, dtype=dt,
                                                use_pallas=cfg.gru_pallas))
        self.logits = Dense(2 * H, vocab_size)

    def _lc_backward(self, gru, x, pvalid):
        """Window-bounded backward GRU: windows [c Nc, c Nc + Nc + Nr)
        folded into the batch, zero initial state per window."""
        cfg = self.cfg
        B, T, D = x.shape
        Nc, Nr = cfg.lc_chunk, cfg.lc_lookahead
        n = -(-T // Nc)
        Tp, W = n * Nc, Nc + Nr
        xp = F.pad(x, (0, 0, 0, Tp + Nr - T))
        starts = torch.arange(n, device=x.device) * Nc
        idx = starts[:, None] + torch.arange(W, device=x.device)[None, :]
        xw = xp[:, idx].reshape(B * n, W, D)
        lw = torch.clamp(pvalid[:, None] - starts[None, :], 0, W).reshape(B * n)
        yw = gru(xw, lw)  # [B n, W, H]
        return yw[:, :Nc].reshape(B, Tp, yw.shape[-1])[:, :T]

    def forward(self, feats: torch.Tensor, lengths: torch.Tensor):
        cfg = self.cfg
        x, pvalid, _ = self._front(feats, lengths, self._zero_tail(feats.shape[0], feats.device))
        for i in range(cfg.num_gru_layers):
            f = getattr(self, f"fwd{i}")(x, pvalid)
            b = self._lc_backward(getattr(self, f"bwd{i}"), x, pvalid)
            x = torch.cat([f, b], -1)
        logits = self.logits(x, torch.float32)
        return logits * _length_mask(logits, pvalid), pvalid

    def step(self, feats: torch.Tensor, abs_start: torch.Tensor, valid_frames: torch.Tensor,
             carry):
        """One streaming chunk of C = lc_chunk * patch feature frames.

        feats [B, C, D]; abs_start [B] absolute feature-frame index of the
        chunk's first frame (multiples of C per slot); valid_frames [B] the
        stream's total valid feature frames (huge = open-ended, re-read
        every step); carry from ``lc_initial_carry``. Returns (logits
        [B, Nc, V] of the chunk num_gru_layers chunks back, all masked
        until the pipeline fills, and the new carry)."""
        cfg = self.cfg
        Nc, Nr = cfg.lc_chunk, cfg.lc_lookahead
        P = self.patch
        C = Nc * P
        tail, bufs, hfs = carry
        k = torch.div(abs_start, C, rounding_mode="floor")  # arriving chunk index
        fv = torch.clamp(valid_frames - abs_start, 0, C)
        x_new, _, new_tail = self._front(feats, fv, tail)
        tvp = torch.clamp((valid_frames + P - 1) // P, max=_OPEN)  # total valid patches
        new_bufs, new_hfs = [], []
        for i in range(cfg.num_gru_layers):
            kb = k - 1 - i  # buffered chunk index at this layer
            buf = bufs[i]
            win = torch.cat([buf, x_new[:, :Nr].to(torch.float32)], 1)
            base = torch.where(kb >= 0, kb * Nc, _OPEN)
            lw = torch.clamp(tvp - base, 0, Nc + Nr)
            bwd = getattr(self, f"bwd{i}")(win, lw)[:, :Nc]
            lf = torch.clamp(tvp - base, 0, Nc)
            fwd, h_end = getattr(self, f"fwd{i}")(buf, lf, h0=hfs[i], return_final=True)
            new_bufs.append(x_new.to(torch.float32))
            new_hfs.append(h_end)
            x_new = torch.cat([fwd, bwd], -1)
        logits = self.logits(x_new, torch.float32)
        ke = k - cfg.num_gru_layers  # emitted chunk index
        base_e = torch.where(ke >= 0, ke * Nc, _OPEN)
        ve = torch.clamp(tvp - base_e, 0, Nc)
        logits = logits * _length_mask(logits, ve)
        return logits, (new_tail, tuple(new_bufs), tuple(new_hfs))


def lc_initial_carry(cfg: ModelConfig, batch: int, device="cpu"):
    """Zero streaming state of ``LCBiGRUEncoder.step``: (ctx_tail
    [B, kernel-1, H], per-layer input-chunk buffers (f32; layer 0's
    [B, Nc, H], later layers' [B, Nc, 2H]), per-layer forward states
    [B, H]). Every leaf has the batch leading."""
    dt = _dtype(cfg)
    H, Nc, L = cfg.hidden_size, cfg.lc_chunk, cfg.num_gru_layers
    bufs = tuple(torch.zeros(batch, Nc, H if i == 0 else 2 * H, device=device)
                 for i in range(L))
    hfs = tuple(torch.zeros(batch, H, dtype=dt, device=device) for _ in range(L))
    return torch.zeros(batch, cfg.conv_kernel - 1, H, dtype=dt, device=device), bufs, hfs


def uni_gru_initial_carry(cfg: ModelConfig, batch: int, device="cpu"):
    """Zero streaming state of ``UniGRUEncoder.step``: (ctx_tail
    [B, kernel-1, H], h [num_gru_layers, B, H]); h has the batch on axis
    1, as the JAX package's."""
    dt = _dtype(cfg)
    return (torch.zeros(batch, cfg.conv_kernel - 1, cfg.hidden_size, dtype=dt, device=device),
            torch.zeros(cfg.num_gru_layers, batch, cfg.hidden_size, dtype=dt, device=device))


def _sinusoidal_positions(T: int, D: int, device=None) -> torch.Tensor:
    """The fixed sin/cos position table [T, D], in f32 as the JAX package
    computes it."""
    f32 = torch.float32
    pos = torch.arange(T, device=device, dtype=f32)[:, None]
    div = torch.exp(torch.arange(0, D, 2, device=device, dtype=f32)
                    * torch.tensor(-math.log(10000.0) / D, dtype=f32))
    pe = torch.zeros(T, D, dtype=f32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div[: D // 2])
    return pe


class _AttentionBase(nn.Module):
    """The subsampling front, ``in_proj`` and f32 ``logits`` the attention
    encoders share, and the dense / LayerNorm / attention layers they add
    by flax name."""

    def __init__(self, cfg: ModelConfig, vocab_size: int, input_dim: int):
        super().__init__()
        self.cfg = cfg
        dt = _dtype(cfg)
        self.front_names = []
        for name, mod in _make_front(cfg, input_dim, dt).items():
            self.add_module(name, mod)
            self.front_names.append(name)
        self.in_proj = Dense(_front_width(cfg, input_dim), cfg.hidden_size)
        self.logits = Dense(cfg.hidden_size, vocab_size)

    def _dense(self, name: str, d_in: int, d_out: int) -> None:
        self.add_module(name, Dense(d_in, d_out))

    def _norm(self, name: str) -> None:
        self.add_module(name, LayerNorm(self.cfg.hidden_size))

    def _mha(self, name: str) -> None:
        cfg = self.cfg
        self.add_module(name, MultiHeadAttention(cfg.hidden_size, cfg.num_heads, _dtype(cfg),
                                                 cfg.attn_pallas, cfg.dropout))

    def reset_parameters(self, generator: torch.Generator) -> None:
        for mod in self.children():
            mod.reset_parameters(generator)

    def _embed(self, feats, lengths):
        front = [getattr(self, n) for n in self.front_names]
        x, lengths = _subsample_front(self.cfg, front, feats, lengths, _dtype(self.cfg))
        return self.in_proj(x, _dtype(self.cfg)), lengths

    def _ffn(self, x, first: str, second: str, act):
        dt = _dtype(self.cfg)
        return getattr(self, second)(act(getattr(self, first)(x, dt)), dt)


class TransformerEncoder(_AttentionBase):
    """conv subsampling -> ``in_proj`` + sin/cos positions -> N pre-LN
    transformer blocks (MHSA with a key padding mask, GELU FFN) ->
    ``ln_out`` -> f32 dense logits. flax's ``nn.gelu`` is the tanh
    approximation; the position table is cast to the compute dtype
    before it is added."""

    def __init__(self, cfg: ModelConfig, vocab_size: int, input_dim: int):
        super().__init__(cfg, vocab_size, input_dim)
        H, ffn = cfg.hidden_size, cfg.ffn_dim or 4 * cfg.hidden_size
        for i in range(cfg.transformer_layers):
            self._norm(f"ln_a{i}")
            self._mha(f"mha{i}")
            self._norm(f"ln_f{i}")
            self._dense(f"ffn_in{i}", H, ffn)
            self._dense(f"ffn_out{i}", ffn, H)
        self._norm("ln_out")

    def forward(self, feats: torch.Tensor, lengths: torch.Tensor):
        cfg = self.cfg
        dt = _dtype(cfg)
        x, lengths = self._embed(feats, lengths)
        T2 = x.shape[1]
        x = x + _sinusoidal_positions(T2, cfg.hidden_size, x.device).to(dt)
        x = x * _length_mask(x, lengths)
        key_mask = torch.arange(T2, device=x.device)[None, :] < lengths[:, None]
        attn_mask = key_mask[:, None, None, :]  # [B, 1, 1(q), T(k)]
        for i in range(cfg.transformer_layers):
            x = x + getattr(self, f"mha{i}")(getattr(self, f"ln_a{i}")(x), attn_mask)
            h = self._ffn(getattr(self, f"ln_f{i}")(x), f"ffn_in{i}", f"ffn_out{i}",
                          lambda y: F.gelu(y, approximate="tanh"))
            if cfg.dropout > 0:
                h = F.dropout(h, cfg.dropout, self.training)
            # bias/LN terms make padding rows nonzero; the key mask guards
            # keys, this keeps the padding region of the output clean
            x = (x + h) * _length_mask(x, lengths)
        x = self.ln_out(x)
        logits = self.logits(x, torch.float32)
        return logits * _length_mask(logits, lengths), lengths


class ConformerConvModule(nn.Module):
    """Conformer convolution module: pointwise GLU (``pw_in``) -> masked
    depthwise conv ("SAME", ``groups = hidden``) -> LayerNorm
    (flax's unnamed ``LayerNorm_0``) -> swish -> pointwise (``pw_out``)."""

    def __init__(self, hidden: int, kernel: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.pw_in = Dense(hidden, 2 * hidden)
        self.depthwise = Conv1d(hidden, hidden, kernel, groups=hidden)
        self.norm = LayerNorm(hidden)
        self.pw_out = Dense(hidden, hidden)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for mod in self.children():
            mod.reset_parameters(generator)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        a, b = self.pw_in(x, dt).chunk(2, -1)
        x = a * torch.sigmoid(b)  # GLU
        x = x * _length_mask(x, lengths)  # the depthwise window never reads padding
        x = F.silu(self.norm(self.depthwise(x, dt)))
        return self.pw_out(x, dt)


class ConformerEncoder(_AttentionBase):
    """conv subsampling -> N conformer blocks (macaron half-FFNs with
    swish, MHSA with a learned clipped relative-position bias
    ``rel_bias{i}`` [heads, 2R+1] read through the Toeplitz index
    ``table[:, rel_idx]``, the conv module, ``ln_post{i}``) -> f32 dense
    logits. The bias is cast to the compute dtype before the attention
    (so K6 gets it rounded to bf16 in a bf16 model, as the JAX package's
    kernel does)."""

    def __init__(self, cfg: ModelConfig, vocab_size: int, input_dim: int):
        super().__init__(cfg, vocab_size, input_dim)
        H, ffn = cfg.hidden_size, cfg.ffn_dim or 4 * cfg.hidden_size
        R = cfg.conformer_rel_clip
        for i in range(cfg.transformer_layers):
            self._norm(f"ln_f1_{i}")
            self._dense(f"ffn1_in{i}", H, ffn)
            self._dense(f"ffn1_out{i}", ffn, H)
            self.register_parameter(f"rel_bias{i}",
                                    nn.Parameter(torch.zeros(cfg.num_heads, 2 * R + 1)))
            self._norm(f"ln_a{i}")
            self._mha(f"mha{i}")
            self._norm(f"ln_c{i}")
            self.add_module(f"cfm_conv{i}", ConformerConvModule(H, cfg.conformer_kernel,
                                                                _dtype(cfg)))
            self._norm(f"ln_f2_{i}")
            self._dense(f"ffn2_in{i}", H, ffn)
            self._dense(f"ffn2_out{i}", ffn, H)
            self._norm(f"ln_post{i}")

    def reset_parameters(self, generator: torch.Generator) -> None:
        super().reset_parameters(generator)
        for i in range(self.cfg.transformer_layers):
            nn.init.zeros_(getattr(self, f"rel_bias{i}"))

    def forward(self, feats: torch.Tensor, lengths: torch.Tensor):
        cfg = self.cfg
        dt = _dtype(cfg)
        x, lengths = self._embed(feats, lengths)
        T = x.shape[1]
        x = x * _length_mask(x, lengths)
        ar = torch.arange(T, device=x.device)
        key_mask = ar[None, :] < lengths[:, None]
        attn_mask = key_mask[:, None, None, :]  # [B, 1, 1(q), T(k)]
        R = cfg.conformer_rel_clip
        rel_idx = torch.clamp(ar[None, :] - ar[:, None], -R, R) + R  # [T, T] in [0, 2R]
        for i in range(cfg.transformer_layers):
            h = self._ffn(getattr(self, f"ln_f1_{i}")(x), f"ffn1_in{i}", f"ffn1_out{i}", F.silu)
            x = x + 0.5 * h  # macaron half-FFN
            bias = getattr(self, f"rel_bias{i}")[:, rel_idx][None]  # [1, H, T, T]
            h = getattr(self, f"mha{i}")(getattr(self, f"ln_a{i}")(x), attn_mask, bias.to(dt))
            x = (x + h) * _length_mask(x, lengths)
            x = x + getattr(self, f"cfm_conv{i}")(getattr(self, f"ln_c{i}")(x), lengths)
            h = self._ffn(getattr(self, f"ln_f2_{i}")(x), f"ffn2_in{i}", f"ffn2_out{i}", F.silu)
            x = x + 0.5 * h
            x = getattr(self, f"ln_post{i}")(x)
            x = x * _length_mask(x, lengths)
        logits = self.logits(x, torch.float32)
        return logits * _length_mask(logits, lengths), lengths


def _flax_init(module: nn.Module, generator: torch.Generator) -> None:
    """Initialise ``module``'s dense and conv layers as flax does by
    default (truncated lecun normal kernels, zero biases) and its
    LayerNorms to the identity."""
    for mod in module.children():
        if isinstance(mod, (Dense, Conv1d)):
            lecun_truncated_normal_(mod.weight, mod.weight[0].numel(), generator)
            nn.init.zeros_(mod.bias)
        else:
            mod.reset_parameters(generator)


class PhoneClassifier(nn.Module):
    """Per-frame phone posterior model (GAN generator / EODM model): a
    "SAME" conv of ``2 * classifier_context + 1`` frames, then
    ``classifier_layers - 1`` dense layers, LayerNorm (eps 1e-6) + ReLU
    after each, and f32 dense logits, masked past each length. ``norm{i}``
    follow flax's ``LayerNorm_{i}``."""

    def __init__(self, cfg: ModelConfig, vocab_size: int, input_dim: int):
        super().__init__()
        if cfg.int8_compute:
            raise NotImplementedError(
                "model.int8_compute (int8 tensor-core GEMMs) is not ported yet "
                "(ROADMAP.md Queue 1, item 13: quantize and export)")
        self.cfg = cfg
        H = cfg.classifier_hidden
        self.context_conv = Conv1d(input_dim, H, 2 * cfg.classifier_context + 1)
        for i in range(cfg.classifier_layers - 1):
            self.add_module(f"fc{i}", Dense(H, H))
        for i in range(cfg.classifier_layers):
            self.add_module(f"norm{i}", LayerNorm(H))
        self.logits = Dense(H, vocab_size)

    def reset_parameters(self, generator: torch.Generator) -> None:
        _flax_init(self, generator)

    def forward(self, feats: torch.Tensor, lengths: torch.Tensor):
        dt = _dtype(self.cfg)
        x = feats.to(dt) * _length_mask(feats, lengths)
        x = F.relu(self.norm0(self.context_conv(x, dt)))
        for i in range(self.cfg.classifier_layers - 1):
            x = F.relu(getattr(self, f"norm{i + 1}")(getattr(self, f"fc{i}")(x, dt)))
        logits = self.logits(x, torch.float32)
        return logits * _length_mask(logits, lengths), lengths


class PhoneDiscriminator(nn.Module):
    """GAN critic over phone-distribution sequences [B, T, V]: stacked
    stride-2 "SAME" convs (XLA's split: the high side gets the larger
    half) with leaky ReLU 0.2, lengths shrinking to min((n + 1) // 2, T')
    and the frames past them re-masked after each conv, then masked mean
    and max pooling (-1e30 where masked), a dense layer, leaky ReLU and a
    scalar score. No normalisation (the gradient penalty is defined on
    the raw critic). Always f32, whatever ``model.dtype`` says."""

    def __init__(self, cfg: ModelConfig, vocab_size: int):
        super().__init__()
        self.cfg = cfg
        C = cfg.disc_channels
        for i in range(cfg.disc_layers):
            self.add_module(f"conv{i}", Conv1d(vocab_size if i == 0 else C, C, cfg.disc_kernel,
                                               stride=2))
        self.fc = Dense(2 * C, C)
        self.score = Dense(C, 1)

    def reset_parameters(self, generator: torch.Generator) -> None:
        _flax_init(self, generator)

    def forward(self, probs: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        f32 = torch.float32
        x = probs.to(f32) * _length_mask(probs, lengths)
        for i in range(self.cfg.disc_layers):
            x = F.leaky_relu(getattr(self, f"conv{i}")(x, f32), 0.2)
            lengths = torch.clamp((lengths + 1) // 2, max=x.shape[1])
            # the conv bias makes frames past the length nonzero, and the
            # next strided conv would mix them into valid frames
            x = x * _length_mask(x, lengths)
        mask = _length_mask(x, lengths)
        n = torch.clamp(lengths, min=1).to(f32)[:, None]
        mean_pool = x.sum(1) / n
        max_pool = torch.where(mask, x, torch.full_like(x, -1e30)).amax(1)
        h = F.leaky_relu(self.fc(torch.cat([mean_pool, max_pool], -1), f32), 0.2)
        return self.score(h, f32)[:, 0]


def encoder_time_subsample(cfg: ModelConfig) -> int:
    """Total time-axis subsampling factor of an encoder (logits frames
    per input feature frame)."""
    if cfg.encoder == "classifier":
        return 1
    if cfg.encoder == "cnn":
        return cfg.conv_time_stride  # single strided layer
    if cfg.encoder in ("conv_bigru", "lc_bigru", "transformer", "conformer", "uni_gru"):
        return cfg.conv_time_stride ** cfg.num_conv_layers
    raise ValueError(f"unknown encoder {cfg.encoder!r}")


def build_model(cfg: ModelConfig, vocab_size: int, input_dim: int,
                generator: torch.Generator | None = None, device="cuda") -> nn.Module:
    """Build and initialise an encoder on ``device``. Weights are drawn on
    the CPU from ``generator`` (a fresh generator seeded 0 if None), so a
    seed gives the same weights on every device."""
    if cfg.sequence_shard and cfg.encoder not in ("transformer", "conformer"):
        raise ValueError(
            "model.sequence_shard applies to the attention encoders "
            f"(transformer/conformer), not {cfg.encoder!r}"
        )
    families = {"conv_bigru": ConvBiGRUEncoder, "cnn": CNNEncoder, "uni_gru": UniGRUEncoder,
                "lc_bigru": LCBiGRUEncoder, "transformer": TransformerEncoder,
                "conformer": ConformerEncoder, "classifier": PhoneClassifier}
    if cfg.encoder not in families:
        raise ValueError(f"unknown encoder {cfg.encoder!r}")
    device = resolve_device(device)
    model = families[cfg.encoder](cfg, vocab_size, input_dim)
    model.reset_parameters(generator if generator is not None
                           else torch.Generator().manual_seed(0))
    return model.to(device).eval()


def build_discriminator(cfg: ModelConfig, vocab_size: int,
                        generator: torch.Generator | None = None,
                        device="cuda") -> PhoneDiscriminator:
    """Build and initialise the GAN critic on ``device``, drawn on the CPU
    from ``generator`` (a fresh generator seeded 0 if None)."""
    device = resolve_device(device)
    disc = PhoneDiscriminator(cfg, vocab_size)
    disc.reset_parameters(generator if generator is not None
                          else torch.Generator().manual_seed(0))
    return disc.to(device).eval()
