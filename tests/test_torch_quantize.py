"""int8 quantization (uasr_torch.ops.quantize) and ``model.int8_compute``
against the JAX package's ``uasr.ops.quantize`` on the CPU, on the same
numpy weights from a seed.

- ``quantize_tree`` of the port's weights equals ``flax_to_state_dict`` of
  JAX's quantized kernels: the same leaves, int8 values bit for bit,
  scales rtol 1e-7, the same ``quantized_bytes`` (cnn, conv_bigru's
  grouped GRU weights, the classifier, a transformer's per-dh attention
  projections);
- ``int8_linear`` and ``int8_conv1d`` against ``int8_dot_general`` and a
  flax Conv through ``int8_conv_general_dilated``: rtol 1e-6; and
  ``int8_matmul``'s padding against its plain version, exact;
- the ``int8_compute`` cnn and classifier: logits within the encoder bar
  (f32, 1e-4) of JAX's ``int8_compute=True`` on the same converted
  weights, and the same greedy ids;
- the trainers refuse ``int8_compute``."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn

from uasr.config import ModelConfig as JaxModelConfig
from uasr.models.models import build_model as jax_build_model
from uasr.ops import quantize as jq
from uasr.ops.decode import ctc_greedy_decode as jax_greedy
from uasr_torch.config import Config, ModelConfig
from uasr_torch.convert import flax_to_state_dict
from uasr_torch.models.layers import Conv1d
from uasr_torch.models.models import build_model
from uasr_torch.ops import quantize as tq
from uasr_torch.ops.decode import ctc_greedy_decode

D, V, T = 24, 10, 16
MODELS = {
    "cnn": dict(encoder="cnn", hidden_size=64, num_conv_layers=2, conv_time_stride=2,
                conv_kernel=5),
    "conv_bigru": dict(encoder="conv_bigru", hidden_size=32, num_gru_layers=1,
                       conv_channels=4),
    "classifier": dict(encoder="classifier", classifier_hidden=64, classifier_layers=2,
                       classifier_context=2),
    "transformer": dict(encoder="transformer", hidden_size=64, num_heads=4,
                        transformer_layers=1, ffn_dim=128),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite runs files in parallel workers."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    return rng.randn(3, T, D).astype(np.float32), np.array([T, 11, 5], np.int32)


@pytest.fixture(scope="module")
def jax_params():
    """JAX's seeded weights of each model as numpy, drawn once and shared by
    the tests (the int8_compute model has the same parameters)."""
    cache = {}

    def get(name):
        if name not in cache:
            jm = jax_build_model(JaxModelConfig(**MODELS[name]), V)
            x, n = _inputs()
            cache[name] = jax.tree.map(np.asarray,
                                       jax.jit(jm.init)(jax.random.PRNGKey(3), x, n))
        return cache[name]

    return get


def _pair(params, name, int8=False):
    """(JAX model, port model on the converted ``params``)."""
    kw = dict(MODELS[name], int8_compute=int8)
    cfg = ModelConfig(**kw)
    pm = build_model(cfg, V, D, device="cpu")
    pm.load_state_dict(flax_to_state_dict(params, cfg))
    return jax_build_model(JaxModelConfig(**kw), V), pm


def _map_q(node, leaf, other):
    if jq._is_quantized_leaf(node):
        return leaf(node)
    if isinstance(node, dict):
        return {k: _map_q(v, leaf, other) for k, v in node.items()}
    return other(node)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_quantize_tree_matches_jax_after_conversion(jax_params, name):
    params = jax_params(name)
    _, pm = _pair(params, name)
    cfg = ModelConfig(**MODELS[name])
    qt, n = jq.quantize_tree(params)
    pt, pn = tq.quantize_tree(pm)
    assert pn == n > 0

    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    mask = flax_to_state_dict(_map_q(qt, lambda q: np.ones(q["qint8"].shape),
                                     lambda a: np.zeros(np.shape(a))), cfg)
    assert {k for k, v in mask.items() if bool((v == 1).all())} == {
        k for k, v in pt.items() if isinstance(v, tq.QLeaf)}
    q8 = flax_to_state_dict(_map_q(qt, lambda q: f32(q["qint8"]), f32), cfg)
    sc = flax_to_state_dict(_map_q(qt, lambda q: np.broadcast_to(q["qscale"], q["qint8"].shape),
                                   f32), cfg)
    deq = flax_to_state_dict(jax.tree.map(np.asarray, jq.dequantize_tree(qt)), cfg)
    ported = tq.dequantize_tree(pt)
    for k, v in pt.items():
        if isinstance(v, tq.QLeaf):
            assert v.qint8.dtype == torch.int8
            torch.testing.assert_close(v.qint8.reshape(v.shape).float(), q8[k], rtol=0, atol=0)
            torch.testing.assert_close(torch.broadcast_to(v.qscale, v.qint8.shape)
                                       .reshape(v.shape), sc[k], rtol=1e-7, atol=0)
        torch.testing.assert_close(ported[k].detach(), deq[k], rtol=1e-7, atol=0)
    assert tq.quantized_bytes(pt) == jq.quantized_bytes(qt)


@pytest.mark.parametrize("shape", [(5, 64), (2, 7, 48)])
def test_int8_linear_matches_int8_dot_general(shape):
    rng = np.random.RandomState(1)
    x = (rng.randn(*shape) * np.exp(rng.randn(shape[-1]))).astype(np.float32)
    w = (rng.randn(shape[-1], 40) * np.exp(rng.randn(40))).astype(np.float32)  # flax [in, out]
    want = jq.int8_dot_general(jnp.asarray(x), jnp.asarray(w),
                               (((x.ndim - 1,), (0,)), ((), ())))
    got = tq.int8_linear(torch.tensor(x), torch.tensor(w.T))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize("k,stride,dilation,Tx", [(5, 2, 1, 17), (5, 1, 2, 16), (3, 1, 4, 9)])
def test_int8_conv_matches_int8_conv_general_dilated(k, stride, dilation, Tx):
    rng = np.random.RandomState(2)
    C, O = 12, 20
    x = rng.randn(2, Tx, C).astype(np.float32)
    kernel = rng.randn(k, C, O).astype(np.float32)
    bias = rng.randn(O).astype(np.float32)
    conv = fnn.Conv(O, (k,), strides=(stride,), kernel_dilation=(dilation,), padding="SAME",
                    conv_general_dilated=jq.int8_conv_general_dilated)
    want = conv.apply({"params": {"kernel": kernel, "bias": bias}}, x)
    pc = Conv1d(C, O, k, stride=stride, dilation=dilation, int8=True)
    pc.load_state_dict({"weight": torch.tensor(kernel.transpose(2, 1, 0)),
                        "bias": torch.tensor(bias)})
    got = pc(torch.tensor(x), torch.float32)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize("M,K,N", [(3, 20, 5), (16, 8, 8), (17, 13, 30), (40, 64, 16)])
def test_int8_matmul_padding_matches_plain(M, K, N):
    rng = np.random.RandomState(M + K + N)
    a = torch.tensor(rng.randint(-127, 128, (M, K)), dtype=torch.int8)
    b = torch.tensor(rng.randint(-127, 128, (N, K)), dtype=torch.int8)
    got = tq.int8_matmul(a, b)
    assert got.dtype == torch.int32 and got.shape == (M, N)
    assert torch.equal(got, tq.int8_matmul_reference(a, b))
    assert torch.equal(got.long(), a.long() @ b.long().T)


@pytest.mark.parametrize("name", ["cnn", "classifier"])
def test_int8_compute_logits_and_ids_match_jax(jax_params, name):
    params = jax_params(name)
    jm, pm = _pair(params, name, int8=True)
    x, n = _inputs(5)
    jl, jn = jax.jit(jm.apply)(params, x, n)
    with torch.no_grad():
        pl, pn = pm(torch.tensor(x), torch.tensor(n))
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
    assert pn.tolist() == np.asarray(jn).tolist()
    jids, jlen = jax_greedy(jl, jn, 0)
    ids, lens = ctc_greedy_decode(pl, pn, 0)
    assert lens.tolist() == np.asarray(jlen).tolist()
    for b, m in enumerate(lens.tolist()):
        assert ids[b, :m].tolist() == np.asarray(jids)[b, :m].tolist()


def test_int8_compute_refuses_training():
    from uasr_torch.train import CTCTrainer, EODMTrainer, GANTrainer

    cnn = Config(model=ModelConfig(**MODELS["cnn"], int8_compute=True), vocab_size=V)
    trainer = CTCTrainer(cnn, device="cpu")  # builds for decode
    with pytest.raises(ValueError, match="int8_compute"):
        trainer.train_step(trainer.init_state(), None)
    gen = Config(model=ModelConfig(**MODELS["classifier"], int8_compute=True), vocab_size=V)
    gen = dataclasses.replace(gen, train=dataclasses.replace(gen.train, mode="gan"))
    with pytest.raises(ValueError, match="int8_compute"):
        GANTrainer(gen, device="cpu")
    with pytest.raises(ValueError, match="int8_compute"):
        EODMTrainer(gen, [[1, 2, 3]], device="cpu")
