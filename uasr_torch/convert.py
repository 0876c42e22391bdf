"""Weight bridge: the JAX package's flax parameter tree -> the port's
``state_dict``.

Input is the nested dict of numpy arrays that
``jax.tree.map(np.asarray, state.params)`` gives (with or without the
top-level ``"params"`` key); nothing here imports jax. Layouts:

- Dense ``kernel [in, out]`` -> ``weight [out, in]``;
- Conv ``kernel [kh, kw, in, out]`` -> ``[out, in, kh, kw]``, and the
  patch front's context conv ``[k, in, out]`` -> ``[out, in, k]``;
- LayerNorm ``scale`` -> ``weight``;
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


def flax_to_state_dict(params: dict, cfg: ModelConfig | Config) -> dict[str, torch.Tensor]:
    """Map a ``ConvBiGRUEncoder`` flax tree onto ``uasr_torch`` names."""
    if isinstance(cfg, Config):
        cfg = cfg.model
    if cfg.encoder != "conv_bigru":
        raise NotImplementedError(f"weight bridge for encoder {cfg.encoder!r} is not ported yet")
    p = params.get("params", params)
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
