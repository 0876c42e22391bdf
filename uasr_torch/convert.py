"""Weight bridge: the JAX package's flax parameter tree -> the port's
``state_dict``.

Input is the nested dict of numpy arrays that
``jax.tree.map(np.asarray, state.params)`` gives (with or without the
top-level ``"params"`` key); nothing here imports jax. Layouts:

- Dense ``kernel [in, out]`` -> ``weight [out, in]``;
- Conv ``kernel [kh, kw, in, out]`` -> ``[out, in, kh, kw]``, and the
  1-D convs (the patch front's context conv, the cnn encoder's convs)
  ``[k, in, out]`` -> ``[out, in, k]``;
- LayerNorm ``scale`` -> ``weight``; flax names the cnn encoder's unnamed
  LayerNorms ``LayerNorm_0..`` in creation order (its convs', then the
  dilated stack's), which the port's ``norm{i}`` follow;
- BiGRU ``wx [2, D, 3H]``, ``wh [2, H, 3H]``, ``bx``/``bh [2, 3H]`` stay
  grouped, gate order r, z, n.
"""

from __future__ import annotations

import numpy as np
import torch

from uasr_torch.config import Config, ModelConfig


def _t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, dtype=np.float32))


def _dense(out: dict, name: str, p: dict) -> None:
    out[f"{name}.weight"] = _t(np.asarray(p["kernel"]).T)
    out[f"{name}.bias"] = _t(p["bias"])


def _norm(out: dict, name: str, p: dict) -> None:
    out[f"{name}.weight"] = _t(p["scale"])
    out[f"{name}.bias"] = _t(p["bias"])


def _conv1d(out: dict, name: str, p: dict) -> None:
    out[f"{name}.weight"] = _t(np.transpose(p["kernel"], (2, 1, 0)))
    out[f"{name}.bias"] = _t(p["bias"])


def _cnn(p: dict, cfg: ModelConfig) -> dict[str, torch.Tensor]:
    out: dict[str, torch.Tensor] = {}
    n = max(cfg.num_conv_layers, 1)
    for i in range(n):
        _conv1d(out, f"conv{i}", p[f"conv{i}"])
    for i in range(2):
        _conv1d(out, f"dil{i}", p[f"dil{i}"])
    for i in range(n + 2):
        _norm(out, f"norm{i}", p[f"LayerNorm_{i}"])
    _dense(out, "logits", p["logits"])
    return out


def flax_to_state_dict(params: dict, cfg: ModelConfig | Config) -> dict[str, torch.Tensor]:
    """Map a ``ConvBiGRUEncoder`` or ``CNNEncoder`` flax tree onto
    ``uasr_torch`` names."""
    if isinstance(cfg, Config):
        cfg = cfg.model
    p = params.get("params", params)
    if cfg.encoder == "cnn":
        return _cnn(p, cfg)
    if cfg.encoder != "conv_bigru":
        raise NotImplementedError(f"weight bridge for encoder {cfg.encoder!r} is not ported yet")
    out: dict[str, torch.Tensor] = {}
    if cfg.conv_front == "patch":
        q = p["patch"]
        _dense(out, "patch.embed", q["embed"])
        _norm(out, "patch.norm0", q["LayerNorm_0"])
        out["patch.context_weight"] = _t(np.transpose(q["context"]["kernel"], (2, 1, 0)))
        out["patch.context_bias"] = _t(q["context"]["bias"])
        _norm(out, "patch.norm1", q["LayerNorm_1"])
    else:
        for i in range(cfg.num_conv_layers):
            q = p[f"conv{i}"]
            out[f"conv{i}.weight"] = _t(np.transpose(q["Conv_0"]["kernel"], (3, 2, 0, 1)))
            out[f"conv{i}.bias"] = _t(q["Conv_0"]["bias"])
            _norm(out, f"conv{i}.norm", q["LayerNorm_0"])
    for i in range(cfg.num_gru_layers):
        for k in ("wx", "wh", "bx", "bh"):
            out[f"bigru{i}.{k}"] = _t(p[f"bigru{i}"][k])
    _dense(out, "logits", p["logits"])
    return out
