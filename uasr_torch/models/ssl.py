"""Self-supervised (CPC / wav2vec-style) pretraining models (counterpart of
``uasr.models.ssl``): raw waveform (or log-mel frames) ->
``ConvFeatureEncoder`` latents z -> causal GRU context c -> K affine
heads predicting the next K latents, trained with InfoNCE
(``uasr_torch.ops.infonce``). ``uasr_torch.tools.featurize`` dumps c or z
into the feature cache the GAN / EODM trainers read.

The context is the port's ``GRULayer``: with ``ssl.context_pallas`` its
recurrence is ``cuda_gru.gru_scan`` with one group, kernel K5 forward and
K5-bwd (K8 under ``UASR_GRU_BWD_IMPL=linear``) backward on the card, as
the JAX package sends it through ``pallas_gru_scan`` on the TPU.

Parameters are f32 with the compute dtype applied in ``forward`` (flax's
semantics); flax's names map onto the port's in
``uasr_torch.convert.cpc_to_state_dict``. Padding is masked after every
block, so results do not depend on batch padding.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from uasr_torch import resolve_device
from uasr_torch.config import SSLConfig
from uasr_torch.models.layers import Conv1d, Dense, GRULayer, LayerNorm, conv_out_length


def _length_mask(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    return (torch.arange(x.shape[1], device=x.device)[None, :] < lengths[:, None])[..., None]


class ConvFeatureEncoder(nn.Module):
    """Strided 1-D conv stack: [B, L] samples (front ``conv``: [B, L, 1];
    front ``patch``: ``patch_size``-sample patches through ``patch_embed``
    -> ``patch_norm`` -> GELU) or [B, T, D] log-mel frames (``input_type:
    fbank``, the ``fbank_conv_*`` stack) -> [B, T', C] latents. Each block
    is a "SAME" conv -> LayerNorm (eps 1e-6) -> tanh GELU, then the
    lengths follow the stride and the padding is zeroed again."""

    def __init__(self, cfg: SSLConfig, dtype: torch.dtype = torch.float32, feat_dim: int = 80):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        if cfg.input_type == "fbank":
            layers, in_dim = (cfg.fbank_conv_channels, cfg.fbank_conv_kernels,
                              cfg.fbank_conv_strides), feat_dim
        else:
            layers, in_dim = (cfg.conv_channels, cfg.conv_kernels, cfg.conv_strides), 1
            if cfg.front == "patch":
                in_dim = cfg.conv_channels[0]
                self.patch_embed = Dense(cfg.patch_size, in_dim)
                self.patch_norm = LayerNorm(in_dim)
        self.strides = tuple(int(s) for s in layers[2])
        convs, norms = [], []
        for c, k, s in zip(*layers):
            convs.append(Conv1d(in_dim, int(c), int(k), stride=int(s)))
            norms.append(LayerNorm(int(c)))
            in_dim = int(c)
        self.convs, self.norms = nn.ModuleList(convs), nn.ModuleList(norms)
        self.out_dim = in_dim

    def reset_parameters(self, generator: torch.Generator) -> None:
        for m in ([self.patch_embed, self.patch_norm] if hasattr(self, "patch_embed") else []):
            m.reset_parameters(generator)
        for conv, norm in zip(self.convs, self.norms):
            conv.reset_parameters(generator)
            norm.reset_parameters(generator)

    def forward(self, audio: torch.Tensor, lengths: torch.Tensor):
        dt = self.dtype
        if audio.ndim == 3:
            x = audio.to(dt)
        elif hasattr(self, "patch_embed"):
            P = self.cfg.patch_size
            B, L = audio.shape
            x = audio.to(dt) * (torch.arange(L, device=audio.device)[None, :] < lengths[:, None])
            if L % P:
                x = F.pad(x, (0, P - L % P))
            x = F.gelu(self.patch_norm(self.patch_embed(x.reshape(B, -1, P), dt)),
                       approximate="tanh")
            lengths = (lengths + P - 1) // P
        else:
            x = audio[..., None].to(dt)
        x = x * _length_mask(x, lengths)
        for conv, norm, s in zip(self.convs, self.norms, self.strides):
            x = F.gelu(norm(conv(x, dt)), approximate="tanh")
            lengths = torch.clamp(conv_out_length(lengths, s, 1), max=x.shape[1])
            x = x * _length_mask(x, lengths)
        return x, lengths


class CPCModel(nn.Module):
    """Contrastive predictive coding: latents z [B, T, C_z], causal context
    c [B, T, context_hidden] (f32) and K prediction heads as one Dense of
    K * C_z; returns (z, c, preds [B, T, K, C_z], frame lengths). With
    ``fused_loss`` the heads run on the first frame only (preds [B, 1, K,
    C_z]): the fused loss applies their weights chunk by chunk itself, and
    the parameters stay those of the unfused model, so checkpoints are
    interchangeable. ``remat_encoder`` recomputes the encoder in the
    backward (``torch.utils.checkpoint``)."""

    def __init__(self, cfg: SSLConfig, dtype: torch.dtype = torch.float32, feat_dim: int = 80):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        self.encoder = ConvFeatureEncoder(cfg, dtype, feat_dim)
        cz = self.encoder.out_dim
        self.context = GRULayer(cz, cfg.context_hidden, dtype=dtype,
                                use_pallas=cfg.context_pallas)
        self.heads = Dense(cfg.context_hidden, cfg.predict_steps * cz)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.encoder.reset_parameters(generator)
        self.context.reset_parameters(generator)
        self.heads.reset_parameters(generator)

    def forward(self, audio: torch.Tensor, lengths: torch.Tensor):
        if self.cfg.remat_encoder and torch.is_grad_enabled():
            z, flen = checkpoint(self.encoder, audio, lengths, use_reentrant=False)
        else:
            z, flen = self.encoder(audio, lengths)
        c = self.context(z, flen)
        B, T, Cz = z.shape
        K = self.cfg.predict_steps
        if self.cfg.fused_loss:
            return z, c, self.heads(c[:, :1], self.dtype).reshape(B, 1, K, Cz), flen
        return z, c, self.heads(c, self.dtype).reshape(B, T, K, Cz), flen


def build_cpc_model(cfg: SSLConfig, dtype: torch.dtype, feat_dim: int,
                    generator: torch.Generator | None = None, device="cuda") -> CPCModel:
    """A ``CPCModel`` on ``device``, its weights drawn on the CPU from
    ``generator`` (a fresh generator seeded 0 if None)."""
    model = CPCModel(cfg, dtype, feat_dim)
    model.reset_parameters(generator if generator is not None
                           else torch.Generator().manual_seed(0))
    return model.to(resolve_device(device)).eval()
