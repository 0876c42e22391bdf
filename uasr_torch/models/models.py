"""Encoder families (counterpart of ``uasr.models.models``).

Ported so far: ``ConvBiGRUEncoder`` (conv or patch subsampling front ->
N x BiGRU -> f32 dense logits incl. blank), the supervised CTC acoustic
model, and ``CNNEncoder`` (strided conv, dilated residual stack, f32
dense logits), the streaming recipe's encoder. ``build_model`` raises
``NotImplementedError`` for the other families until their slices land
(ROADMAP.md Queue 1).

All encoders take (features [B, T, D], lengths [B]) and return
(logits [B, T', V], lengths [B]). ``model.dropout`` acts after each BiGRU
in ``train()`` mode only; ``build_model`` returns the model in ``eval()``
mode and the trainer switches it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from uasr_torch import resolve_device
from uasr_torch.config import ModelConfig
from uasr_torch.models.layers import (
    BiGRU, Conv1d, ConvBlock, Dense, LayerNorm, conv_out_length, lecun_normal_, same_padding,
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
    if cfg.encoder in ("lc_bigru", "uni_gru", "transformer", "conformer"):
        raise NotImplementedError(
            f"encoder {cfg.encoder!r} is not ported yet "
            "(ROADMAP.md Queue 1, slice 3: the other CTC encoders)"
        )
    if cfg.encoder == "classifier":
        raise NotImplementedError(
            "encoder 'classifier' is not ported yet (ROADMAP.md Queue 1: "
            "the unsupervised GAN/EODM slice)"
        )
    families = {"conv_bigru": ConvBiGRUEncoder, "cnn": CNNEncoder}
    if cfg.encoder not in families:
        raise ValueError(f"unknown encoder {cfg.encoder!r}")
    device = resolve_device(device)
    model = families[cfg.encoder](cfg, vocab_size, input_dim)
    model.reset_parameters(generator if generator is not None
                           else torch.Generator().manual_seed(0))
    return model.to(device).eval()
