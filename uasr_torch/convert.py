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
  grouped, gate order r, z, n; the recurrent encoders' GRU layers
  (``gru{i}``, ``fwd{i}``, ``bwd{i}``) keep ``wx [D, 3H]``, ``wh [H, 3H]``,
  ``bx``/``bh [3H]``;
- the recurrent encoders' causal front: ``embed``, ``embed_ln``,
  ``context`` (VALID conv ``[k, H, H]`` -> ``[H, H, k]``), ``context_ln``;
- attention ``query``/``key``/``value`` ``kernel [D, heads, dh]`` ->
  ``weight [heads * dh, D]`` with bias [heads * dh], and ``out`` ``kernel
  [heads, dh, D]`` -> ``weight [D, heads * dh]``: the projections stay
  packed; the conformer's depthwise conv ``kernel [k, 1, H]`` ->
  ``[H, 1, k]``, its conv module's unnamed ``LayerNorm_0`` -> ``norm``, and
  ``rel_bias{i}`` [heads, 2R+1] as it is;
- the classifier generator: ``context_conv`` (``[k, D, H]`` ->
  ``[H, D, k]``), ``fc{i}``, the unnamed ``LayerNorm_{i}`` -> ``norm{i}``,
  ``logits``;
- the GAN critic (``critic_to_state_dict``, the second tree of a
  ``GANState``): ``conv{i}`` (stride-2 1-D convs), ``fc``, ``score``;
- the SSL ``CPCModel`` (``cpc_to_state_dict``): the encoder's
  ``patch_embed`` / ``patch_norm`` (front ``patch``), ``conv{i}`` (``[k,
  in, out]`` -> ``encoder.convs.{i}`` ``[out, in, k]``) and its unnamed
  ``LayerNorm_{i}`` in creation order -> ``encoder.norms.{i}``; the
  ``context`` GRU's ``wx``, ``wh``, ``bx``, ``bh``; the ``heads`` Dense.
"""

from __future__ import annotations

import numpy as np
import torch

from uasr_torch.config import Config, ModelConfig, SSLConfig


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


def _gru(out: dict, name: str, p: dict) -> None:
    for k in ("wx", "wh", "bx", "bh"):
        out[f"{name}.{k}"] = _t(p[k])


def _recurrent(p: dict, cfg: ModelConfig) -> dict[str, torch.Tensor]:
    out: dict[str, torch.Tensor] = {}
    _dense(out, "embed", p["embed"])
    _norm(out, "embed_ln", p["embed_ln"])
    _conv1d(out, "context", p["context"])
    _norm(out, "context_ln", p["context_ln"])
    names = (("gru",) if cfg.encoder == "uni_gru" else ("fwd", "bwd"))
    for i in range(cfg.num_gru_layers):
        for n in names:
            _gru(out, f"{n}{i}", p[f"{n}{i}"])
    _dense(out, "logits", p["logits"])
    return out


def _heads(out: dict, name: str, p: dict) -> None:
    """One flax DenseGeneral of multi-head attention, flattened to Dense."""
    k, b = np.asarray(p["kernel"]), np.asarray(p["bias"])
    if name.endswith(".out"):  # [heads, dh, D]
        out[f"{name}.weight"] = _t(k.reshape(-1, k.shape[-1]).T)
    else:  # [D, heads, dh]
        out[f"{name}.weight"] = _t(k.reshape(k.shape[0], -1).T)
    out[f"{name}.bias"] = _t(b.reshape(-1))


def _mha(out: dict, name: str, p: dict) -> None:
    for k in ("query", "key", "value", "out"):
        _heads(out, f"{name}.{k}", p[k])


def _attention(p: dict, cfg: ModelConfig) -> dict[str, torch.Tensor]:
    out = _front(p, cfg)
    _dense(out, "in_proj", p["in_proj"])
    for i in range(cfg.transformer_layers):
        if cfg.encoder == "transformer":
            dense, norms = (f"ffn_in{i}", f"ffn_out{i}"), (f"ln_a{i}", f"ln_f{i}")
        else:
            dense = (f"ffn1_in{i}", f"ffn1_out{i}", f"ffn2_in{i}", f"ffn2_out{i}")
            norms = (f"ln_f1_{i}", f"ln_a{i}", f"ln_c{i}", f"ln_f2_{i}", f"ln_post{i}")
            out[f"rel_bias{i}"] = _t(p[f"rel_bias{i}"])
            q = p[f"cfm_conv{i}"]
            _dense(out, f"cfm_conv{i}.pw_in", q["pw_in"])
            _conv1d(out, f"cfm_conv{i}.depthwise", q["depthwise"])
            _norm(out, f"cfm_conv{i}.norm", q["LayerNorm_0"])
            _dense(out, f"cfm_conv{i}.pw_out", q["pw_out"])
        for n in dense:
            _dense(out, n, p[n])
        for n in norms:
            _norm(out, n, p[n])
        _mha(out, f"mha{i}", p[f"mha{i}"])
    if cfg.encoder == "transformer":
        _norm(out, "ln_out", p["ln_out"])
    _dense(out, "logits", p["logits"])
    return out


def _front(p: dict, cfg: ModelConfig) -> dict[str, torch.Tensor]:
    """The conv2d or patch subsampling front."""
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
    return out


def _classifier(p: dict, cfg: ModelConfig) -> dict[str, torch.Tensor]:
    out: dict[str, torch.Tensor] = {}
    _conv1d(out, "context_conv", p["context_conv"])
    for i in range(cfg.classifier_layers - 1):
        _dense(out, f"fc{i}", p[f"fc{i}"])
    for i in range(cfg.classifier_layers):
        _norm(out, f"norm{i}", p[f"LayerNorm_{i}"])
    _dense(out, "logits", p["logits"])
    return out


def critic_to_state_dict(params: dict, cfg: ModelConfig | Config) -> dict[str, torch.Tensor]:
    """Map a flax ``PhoneDiscriminator`` tree (a ``GANState``'s
    ``d_params``) onto ``uasr_torch.models.models.PhoneDiscriminator``."""
    if isinstance(cfg, Config):
        cfg = cfg.model
    p = params.get("params", params)
    out: dict[str, torch.Tensor] = {}
    for i in range(cfg.disc_layers):
        _conv1d(out, f"conv{i}", p[f"conv{i}"])
    _dense(out, "fc", p["fc"])
    _dense(out, "score", p["score"])
    return out


def flax_to_state_dict(params: dict, cfg: ModelConfig | Config) -> dict[str, torch.Tensor]:
    """Map a flax encoder tree (``conv_bigru``, ``cnn``, ``uni_gru``,
    ``lc_bigru``, ``transformer``, ``conformer``, ``classifier``) onto
    ``uasr_torch`` names."""
    if isinstance(cfg, Config):
        cfg = cfg.model
    p = params.get("params", params)
    if cfg.encoder == "cnn":
        return _cnn(p, cfg)
    if cfg.encoder in ("uni_gru", "lc_bigru"):
        return _recurrent(p, cfg)
    if cfg.encoder in ("transformer", "conformer"):
        return _attention(p, cfg)
    if cfg.encoder == "classifier":
        return _classifier(p, cfg)
    if cfg.encoder != "conv_bigru":
        raise ValueError(f"unknown encoder {cfg.encoder!r}")
    out = _front(p, cfg)
    for i in range(cfg.num_gru_layers):
        for k in ("wx", "wh", "bx", "bh"):
            out[f"bigru{i}.{k}"] = _t(p[f"bigru{i}"][k])
    _dense(out, "logits", p["logits"])
    return out


def cpc_to_state_dict(params: dict, cfg: SSLConfig | Config) -> dict[str, torch.Tensor]:
    """Map a flax ``CPCModel`` tree (an ``SSLTrainer`` state's params) onto
    ``uasr_torch.models.ssl.CPCModel``."""
    if isinstance(cfg, Config):
        cfg = cfg.ssl
    p = params.get("params", params)
    enc = p["encoder"]
    out: dict[str, torch.Tensor] = {}
    if "patch_embed" in enc:
        _dense(out, "encoder.patch_embed", enc["patch_embed"])
        _norm(out, "encoder.patch_norm", enc["patch_norm"])
    n = len(cfg.fbank_conv_channels if cfg.input_type == "fbank" else cfg.conv_channels)
    for i in range(n):
        _conv1d(out, f"encoder.convs.{i}", enc[f"conv{i}"])
        _norm(out, f"encoder.norms.{i}", enc[f"LayerNorm_{i}"])
    _gru(out, "context", p["context"])
    _dense(out, "heads", p["heads"])
    return out


def flax_shapes(model: torch.nn.Module) -> dict[str, tuple[int, ...]]:
    """The shape each of ``model``'s parameters has in the flax tree it
    maps from (the inverse of the layouts above): Dense ``weight [out,
    in]`` -> ``[in, out]``; attention ``query``/``key``/``value`` ->
    ``[D, heads, dh]`` with biases ``[heads, dh]``, and ``out`` -> ``[heads,
    dh, D]``; 1-D convs ``[out,
    in, k]`` -> ``[k, in, out]``; the 2-D conv blocks ``[out, in, kh, kw]``
    -> ``[kh, kw, in, out]``; the patch front's ``context_weight`` as a
    1-D conv; the GRUs, LayerNorms, biases and ``rel_bias`` as they are.
    ``uasr_torch.parallel.param_shardings`` applies the JAX package's
    sharding rule to these."""
    from uasr_torch.models.layers import Conv1d, ConvBlock, Dense, MultiHeadAttention

    heads = {name: m.num_heads for name, m in model.named_modules()
             if isinstance(m, MultiHeadAttention)}
    out: dict[str, tuple[int, ...]] = {}
    for mname, mod in model.named_modules():
        for pname, p in mod.named_parameters(recurse=False):
            name = f"{mname}.{pname}" if mname else pname
            shape = tuple(p.shape)
            parent, _, leaf = mname.rpartition(".")
            if (isinstance(mod, Dense) and pname == "bias" and parent in heads
                    and leaf in ("query", "key", "value")):
                shape = (heads[parent], shape[0] // heads[parent])
            elif isinstance(mod, Dense) and pname == "weight":
                if parent in heads and leaf in ("query", "key", "value", "out"):
                    h = heads[parent]
                    if leaf == "out":
                        shape = (h, shape[1] // h, shape[0])
                    else:
                        shape = (shape[1], h, shape[0] // h)
                else:
                    shape = shape[::-1]
            elif (isinstance(mod, Conv1d) and pname == "weight") or pname == "context_weight":
                shape = shape[::-1]
            elif isinstance(mod, ConvBlock) and pname == "weight":
                shape = (shape[2], shape[3], shape[1], shape[0])
            out[name] = shape
    return out
