"""The port's ConvBiGRUEncoder and CNNEncoder (uasr_torch.models) on weights
converted from flax (uasr_torch.convert) against the JAX package's encoders
on the CPU."""

import numpy as np
import pytest
import torch

import jax

from uasr.config import ModelConfig as JaxModelConfig
from uasr.models.models import build_model as jax_build_model
from uasr_torch.config import ModelConfig
from uasr_torch.convert import flax_to_state_dict
from uasr_torch.models.models import build_model, encoder_time_subsample

D, V = 12, 7
TOL = {"float32": 1e-4, "bfloat16": 5e-2}


def _models(front, dtype, T, seed=0):
    kw = dict(hidden_size=16, num_gru_layers=2, conv_channels=4, conv_front=front,
              dtype=dtype)
    rng = np.random.RandomState(seed)
    feats = rng.randn(3, T, D).astype(np.float32)
    lengths = np.array([T, T - 5, 3], np.int32)
    jmodel = jax_build_model(JaxModelConfig(**kw), V)
    params = jmodel.init(jax.random.PRNGKey(seed), feats, lengths)
    cfg = ModelConfig(gru_pallas=True, **kw)
    model = build_model(cfg, V, D, device="cpu")
    model.load_state_dict(flax_to_state_dict(jax.tree.map(np.asarray, params), cfg))
    return jmodel, params, model, feats, lengths


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("front,T", [("conv2d", 17), ("conv2d", 18), ("patch", 17),
                                     ("patch", 20)])
def test_encoder_matches_flax(front, T, dtype):
    jmodel, params, model, feats, lengths = _models(front, dtype, T)
    jl, jn = jax.jit(jmodel.apply)(params, feats, lengths)
    with torch.no_grad():
        tl, tn = model(torch.tensor(feats), torch.tensor(lengths, dtype=torch.long))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    assert tl.dtype == torch.float32 and tl.shape == jl.shape
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=TOL[dtype])


@pytest.mark.parametrize("front", ["conv2d", "patch"])
def test_padding_invariance(front):
    """Extending batch padding (by a multiple of the total stride, as in
    tests/test_models.py) leaves every utterance's valid frames unchanged."""
    _, _, model, feats, lengths = _models(front, "float32", 24)
    lens = torch.tensor(lengths, dtype=torch.long)
    padded = np.pad(feats, ((0, 0), (0, 16), (0, 0)))
    with torch.no_grad():
        a, la = model(torch.tensor(feats), lens)
        b, lb = model(torch.tensor(padded), lens)
    np.testing.assert_array_equal(la.numpy(), lb.numpy())
    for i, t in enumerate(la.tolist()):
        np.testing.assert_allclose(a[i, :t].numpy(), b[i, :t].numpy(), rtol=0, atol=2e-5)


def test_state_dict_keys_match_bridge():
    for front in ("conv2d", "patch"):
        _, params, model, _, _ = _models(front, "float32", 16)
        bridged = flax_to_state_dict(jax.tree.map(np.asarray, params), model.cfg)
        assert set(bridged) == set(model.state_dict())
        for k, v in bridged.items():
            assert tuple(v.shape) == tuple(model.state_dict()[k].shape), k


def test_seeded_init_and_families():
    cfg = ModelConfig(hidden_size=8, num_gru_layers=1, conv_channels=2)
    a = build_model(cfg, V, D, generator=torch.Generator().manual_seed(3), device="cpu")
    b = build_model(cfg, V, D, generator=torch.Generator().manual_seed(3), device="cpu")
    for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), k
    wh = a.bigru0.wh[0]
    np.testing.assert_allclose((wh @ wh.T).detach().numpy(), np.eye(8), atol=1e-5)  # orthonormal rows
    assert encoder_time_subsample(cfg) == 4
    cls = ModelConfig(encoder="classifier", classifier_hidden=8, classifier_context=2)
    assert encoder_time_subsample(cls) == 1
    logits, n = build_model(cls, V, D, device="cpu")(torch.randn(2, 20, D), torch.tensor([20, 9]))
    assert logits.shape == (2, 20, V) and n.tolist() == [20, 9]
    for enc in ("transformer", "conformer", "uni_gru", "lc_bigru"):
        small = ModelConfig(encoder=enc, hidden_size=16, num_heads=2, transformer_layers=1,
                            ffn_dim=8, conv_channels=2)
        assert encoder_time_subsample(small) == 4
        logits, n = build_model(small, V, D, device="cpu")(torch.randn(2, 20, D),
                                                            torch.tensor([20, 9]))
        assert logits.shape == (2, 5, V) and n.tolist() == [5, 3]
    cnn = ModelConfig(encoder="cnn", hidden_size=8, conv_kernel=5)
    assert encoder_time_subsample(cnn) == 2
    build_model(cnn, V, D, device="cpu")
    with pytest.raises(NotImplementedError, match="slice 5"):
        build_model(ModelConfig(encoder="cnn", int8_compute=True), V, D, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            build_model(cfg, V, D)


def _cnn_models(dtype, T, seed=0, layers=2):
    kw = dict(encoder="cnn", hidden_size=32, num_conv_layers=layers, conv_time_stride=2,
              conv_kernel=5, dtype=dtype)
    rng = np.random.RandomState(seed)
    feats = rng.randn(3, T, D).astype(np.float32)
    lengths = np.array([T, T - 5, 3], np.int32)
    jmodel = jax_build_model(JaxModelConfig(**kw), V)
    params = jmodel.init(jax.random.PRNGKey(seed), feats, lengths)
    cfg = ModelConfig(**kw)
    model = build_model(cfg, V, D, device="cpu")
    model.load_state_dict(flax_to_state_dict(jax.tree.map(np.asarray, params), cfg))
    return jmodel, params, model, feats, lengths


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,layers", [(17, 2), (18, 2), (24, 1), (21, 3)])
def test_cnn_encoder_matches_flax(T, layers, dtype):
    """Odd and even lengths: flax's SAME padding of the stride-2, kernel-5
    conv is lo 1 / hi 2 on even lengths, and the dilated convs pad
    (k-1)*d split lo/hi."""
    jmodel, params, model, feats, lengths = _cnn_models(dtype, T, layers=layers)
    jl, jn = jax.jit(jmodel.apply)(params, feats, lengths)
    with torch.no_grad():
        tl, tn = model(torch.tensor(feats), torch.tensor(lengths, dtype=torch.long))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    assert tl.dtype == torch.float32 and tl.shape == jl.shape
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=TOL[dtype])


def test_cnn_padding_invariance_and_bridge_keys():
    _, params, model, feats, lengths = _cnn_models("float32", 24)
    bridged = flax_to_state_dict(jax.tree.map(np.asarray, params), model.cfg)
    assert set(bridged) == set(model.state_dict())
    lens = torch.tensor(lengths, dtype=torch.long)
    padded = np.pad(feats, ((0, 0), (0, 16), (0, 0)))
    with torch.no_grad():
        a, la = model(torch.tensor(feats), lens)
        b, lb = model(torch.tensor(padded), lens)
    np.testing.assert_array_equal(la.numpy(), lb.numpy())
    for i, t in enumerate(la.tolist()):
        np.testing.assert_allclose(a[i, :t].numpy(), b[i, :t].numpy(), rtol=0, atol=2e-5)
        assert not b[i, t:].any()  # padding frames stay zero
