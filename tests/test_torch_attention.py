"""The port's attention (uasr_torch.ops.attention, uasr_torch.ops.cuda_attention,
uasr_torch.models.layers.MultiHeadAttention) and attention encoders
(TransformerEncoder, ConformerEncoder) against the JAX package on the CPU.

K6's plain version is held against the JAX package's
fused_dot_product_attention in interpret mode (out f32 5e-6, as
tests/test_pallas_attention.py holds the kernel to flax) and its lse
against the Pallas forward, and at Tp = 832 with K6-bwd's plain version
against jax.grad of the Pallas core; the plain attention against flax's
nn.dot_product_attention; the encoders' logits against the JAX encoders
on converted weights, attn_pallas on (the Pallas kernel in interpret mode
via UASR_PALLAS_ATTN, K6's plain version here) and off (f32 2e-4, the JAX
package's own bar, bf16 5e-2); then the counterparts of the JAX package's
transformer and conformer padding tests and its relative-bias test."""

import numpy as np
import pytest
import torch

import flax.linen as nn
import jax
import jax.numpy as jnp

from uasr.config import ModelConfig as JaxModelConfig
from uasr.models.models import build_model as jax_build_model
from uasr.ops.pallas_attention import _fwd as pallas_attn_fwd
from uasr.ops.pallas_attention import fused_dot_product_attention as jax_fused
from uasr_torch import convert
from uasr_torch.config import ModelConfig
from uasr_torch.convert import flax_to_state_dict
from uasr_torch.models.layers import MultiHeadAttention
from uasr_torch.models.models import build_model
from uasr_torch.ops import cuda_attention
from uasr_torch.ops.attention import dot_product_attention

D, V = 40, 7
TOL = {"float32": 2e-4, "bfloat16": 5e-2}


def _data(B=4, T=37, H=3, dh=16, seed=0):
    """tests/test_pallas_attention.py's inputs: q, k, v [B, T, H, dh], a
    key-only mask with one full row, a batch-shared bias N(0, 0.3^2)."""
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(B, T, H, dh).astype(np.float32) for _ in range(3))
    lengths = rng.randint(1, T + 1, size=B)
    lengths[0] = T
    mask = (np.arange(T)[None, :] < lengths[:, None])[:, None, None, :]
    valid = np.arange(T)[None, :, None, None] < lengths[:, None, None, None]
    bias = (rng.randn(1, H, T, T) * 0.3).astype(np.float32)
    return q, k, v, mask, valid, bias


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("T", [16, 37, 128])
def test_fused_attention_matches_pallas_interpret(T, with_bias):
    q, k, v, mask, valid, bias = _data(T=T)
    b = bias if with_bias else None
    want = jax_fused(q, k, v, bias=b, mask=mask, interpret=True)
    before = cuda_attention.LAUNCHES_ATTN
    got = cuda_attention.fused_dot_product_attention(
        *(torch.tensor(x) for x in (q, k, v)), bias=None if b is None else torch.tensor(b),
        mask=torch.tensor(mask))
    assert cuda_attention.LAUNCHES_ATTN == before  # CPU tensors: K6's plain version
    assert got.shape == q.shape
    np.testing.assert_allclose(np.where(valid, got.numpy(), 0.0),
                               np.where(valid, np.asarray(want), 0.0), rtol=0, atol=5e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_bias", [False, True])
def test_attention_core_out_and_lse_match_pallas(with_bias, dtype):
    """(out, lse) of the padded core against the Pallas forward (interpret):
    T = 37 padded to 40, the padded keys masked."""
    q, k, v, mask, _, bias = _data(T=37)
    B, T, H, dh = q.shape
    Tp = 40
    pad = lambda x: np.pad(x.reshape(B, T, H * dh), ((0, 0), (0, Tp - T), (0, 0)))  # noqa: E731
    q3, k3, v3 = pad(q), pad(k), pad(v)
    kmask = np.pad(mask[:, 0, 0, :].astype(np.int32), ((0, 0), (0, Tp - T)))[:, None, :]
    b3 = np.pad(bias[0], ((0, 0), (0, Tp - T), (0, Tp - T))) if with_bias else None
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jo, jl = pallas_attn_fwd(*(jnp.asarray(x, jdt) for x in (q3, k3, v3)),
                             jnp.asarray(b3) if with_bias else jnp.zeros((0,), jnp.float32),
                             jnp.asarray(kmask), H, with_bias, True)
    to, tl = cuda_attention.attn_core(*(torch.tensor(x).to(tdt) for x in (q3, k3, v3)),
                                      None if b3 is None else torch.tensor(b3),
                                      torch.tensor(kmask), H)
    assert to.dtype == tdt and tl.dtype == torch.float32 and tl.shape == (B, H, Tp)
    tol = 5e-6 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(to.float().numpy(), np.asarray(jo, np.float32), rtol=0, atol=tol)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=5e-6)


def test_plain_versions_match_pallas_past_the_old_length_cap():
    """K6's and K6-bwd's plain versions at Tp = 832 (33 s of audio, past
    the 552 that an earlier K6 kept whole in shared memory) against the Pallas
    forward and jax.grad of _attn_core (interpret): B = 2, 2 heads of 16,
    f32, a bias, a row with 500 valid keys. The card holds K6 and K6-bwd
    against these plain versions at the same length. Bars: out and lse
    5e-6; dq, dk, dv and d_bias 1e-5 of each tensor's largest magnitude."""
    from uasr.ops.pallas_attention import _attn_core

    rng = np.random.RandomState(832)
    B, Tp, H, dh = 2, 832, 2, 16
    q, k, v, w = (rng.randn(B, Tp, H * dh).astype(np.float32) for _ in range(4))
    bias = (0.3 * rng.randn(H, Tp, Tp)).astype(np.float32)
    kmask = (np.arange(Tp)[None] < np.array([Tp, 500])[:, None]).astype(np.int32)[:, None]
    jo, jl = pallas_attn_fwd(*(jnp.asarray(x) for x in (q, k, v, bias, kmask)), H, True, True)

    def loss(*args):
        return jnp.sum(_attn_core(*args, jnp.asarray(kmask), H, True, True) * w)

    want = jax.grad(loss, argnums=(0, 1, 2, 3))(*(jnp.asarray(x) for x in (q, k, v, bias)))
    tq, tk, tv, tb, tm = (torch.tensor(x) for x in (q, k, v, bias, kmask))
    to, tl = cuda_attention.mhsa_fwd_reference(tq, tk, tv, tb, tm, H)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0, atol=5e-6)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=5e-6)
    got = cuda_attention.mhsa_bwd_reference(tq, tk, tv, tb, tm, to, tl, torch.tensor(w), H)
    for g, jg, name in zip(got, want, ["dq", "dk", "dv", "dbias"]):
        jg = np.asarray(jg)
        np.testing.assert_allclose(g.numpy(), jg, rtol=0, atol=1e-5 * float(np.abs(jg).max()),
                                   err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_attention_matches_flax(dtype):
    """ops/attention.py against nn.dot_product_attention: key mask and
    bias, f32 and bf16 (pre-scaled query, weights normalised before PV)."""
    q, k, v, mask, valid, bias = _data(T=21, dh=12)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    want = nn.dot_product_attention(*(jnp.asarray(x, jdt) for x in (q, k, v)),
                                    bias=jnp.asarray(bias, jdt), mask=jnp.asarray(mask))
    got = dot_product_attention(*(torch.tensor(x).to(tdt) for x in (q, k, v)),
                                bias=torch.tensor(bias).to(tdt), mask=torch.tensor(mask))
    assert got.dtype == tdt
    tol = 1e-5 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=0,
                               atol=tol)


def test_fused_wrapper_hands_other_cases_to_plain_attention():
    """A per-example bias, a query-dependent mask and active dropout go to
    the plain attention (the JAX wrapper hands them to flax); the first two
    equal flax."""
    q, k, v, mask, _, bias = _data(T=20)
    B, T = q.shape[:2]
    per_example = np.repeat(bias, B, 0)
    causal = np.tril(np.ones((T, T), bool))[None, None]
    tq = [torch.tensor(x) for x in (q, k, v)]
    before = cuda_attention.LAUNCHES_ATTN
    for kw, jkw in ((dict(bias=torch.tensor(per_example), mask=torch.tensor(mask)),
                     dict(bias=per_example, mask=mask)),
                    (dict(mask=torch.tensor(causal)), dict(mask=causal))):
        got = cuda_attention.fused_dot_product_attention(*tq, **kw)
        want = nn.dot_product_attention(q, k, v, **jkw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    out = cuda_attention.fused_dot_product_attention(*tq, mask=torch.tensor(mask),
                                                     dropout_rate=0.5, deterministic=False,
                                                     generator=torch.Generator().manual_seed(0))
    assert out.shape == q.shape and torch.isfinite(out).all()
    assert cuda_attention.LAUNCHES_ATTN == before


@pytest.mark.parametrize("attn_pallas", [False, True])
def test_multi_head_attention_matches_flax(attn_pallas):
    """flax MultiHeadDotProductAttention (query/key/value DenseGeneral
    [D, heads, dh], out [heads, dh, D]) against the packed port layer."""
    rng = np.random.RandomState(2)
    x = rng.randn(3, 13, 32).astype(np.float32)
    mask = (np.arange(13)[None, :] < np.array([13, 8, 1])[:, None])[:, None, None, :]
    mha = nn.MultiHeadDotProductAttention(num_heads=2)
    params = jax.tree.map(np.asarray, mha.init(jax.random.PRNGKey(0), x, x, mask=mask))
    want = mha.apply(params, x, x, mask=mask)
    layer = MultiHeadAttention(32, 2, attn_pallas=attn_pallas)
    sd = {}
    convert._mha(sd, "mha", params["params"])
    layer.load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items()})
    with torch.no_grad():
        got = layer(torch.tensor(x), torch.tensor(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def _models(encoder, dtype, attn_pallas, T=50, seed=0, **extra):
    kw = dict(encoder=encoder, hidden_size=48, num_heads=4, transformer_layers=2, ffn_dim=64,
              conv_channels=4, dtype=dtype)
    if encoder == "conformer":
        kw.update(conformer_kernel=7, conformer_rel_clip=8)
    kw.update(extra)
    rng = np.random.RandomState(seed)
    feats = rng.randn(4, T, D).astype(np.float32)
    lengths = np.array([T, T - 17, 20, T - 6], np.int32)
    jmodel = jax_build_model(JaxModelConfig(attn_pallas=attn_pallas, **kw), V)
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(seed), feats, lengths))
    # the conformer's rel_bias tables start at zero in flax: draw them, or
    # the bias path is never exercised
    params = jax.tree_util.tree_map_with_path(
        lambda p, x: (0.3 * rng.randn(*x.shape)).astype(np.float32)
        if "rel_bias" in jax.tree_util.keystr(p) else x, params)
    cfg = ModelConfig(attn_pallas=attn_pallas, **kw)
    model = build_model(cfg, V, D, device="cpu")
    model.load_state_dict(flax_to_state_dict(params, cfg))
    return jmodel, params, model, feats, lengths, cfg


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("attn_pallas", [False, True], ids=["flax", "fused"])
@pytest.mark.parametrize("encoder,front", [("transformer", "conv2d"), ("conformer", "conv2d"),
                                           ("transformer", "patch"), ("conformer", "patch")])
def test_encoder_matches_flax(encoder, front, attn_pallas, dtype, monkeypatch):
    if attn_pallas:
        monkeypatch.setenv("UASR_PALLAS_ATTN", "interpret")
    else:
        monkeypatch.delenv("UASR_PALLAS_ATTN", raising=False)
    jmodel, params, model, feats, lengths, _ = _models(encoder, dtype, attn_pallas,
                                                       conv_front=front)
    jl, jn = jax.jit(jmodel.apply)(params, feats, lengths)
    before = cuda_attention.LAUNCHES_ATTN
    with torch.no_grad():
        tl, tn = model(torch.tensor(feats), torch.tensor(lengths, dtype=torch.long))
    assert cuda_attention.LAUNCHES_ATTN == before
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    assert tl.dtype == torch.float32 and tl.shape == jl.shape
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=TOL[dtype])


def test_state_dict_keys_match_bridge():
    for enc in ("transformer", "conformer"):
        _, params, model, _, _, cfg = _models(enc, "float32", True)
        bridged = flax_to_state_dict(params, cfg)
        assert set(bridged) == set(model.state_dict())
        for k, v in bridged.items():
            assert tuple(v.shape) == tuple(model.state_dict()[k].shape), k


@pytest.mark.parametrize("encoder", ["transformer", "conformer"])
def test_attention_padding_invariance(encoder):
    """Counterparts of tests/test_models.py's transformer and conformer
    padding tests (padding a multiple of the front's total stride)."""
    _, _, model, feats, lengths, _ = _models(encoder, "float32", True, T=36)
    lens = torch.tensor(lengths, dtype=torch.long)
    padded = np.pad(feats, ((0, 0), (0, 16), (0, 0)))
    with torch.no_grad():
        a, la = model(torch.tensor(feats), lens)
        b, lb = model(torch.tensor(padded), lens)
    np.testing.assert_array_equal(la.numpy(), lb.numpy())
    for i, t in enumerate(la.tolist()):
        np.testing.assert_allclose(a[i, :t].numpy(), b[i, :t].numpy(), rtol=0, atol=3e-5)
        assert not b[i, t:].any()


def test_conformer_rel_bias_shifts_attention():
    """Counterpart of tests/test_models.py's test: one relative offset
    bumped changes the output (the bias reaches the attention). Offset 0 is
    relative position -clip, which the 6 encoder frames reach only through
    the clip, so the clip is 4 as there."""
    _, _, model, feats, lengths, cfg = _models("conformer", "float32", True, T=24,
                                               transformer_layers=1, conformer_rel_clip=4,
                                               conformer_kernel=3)
    args = (torch.tensor(feats), torch.tensor(lengths, dtype=torch.long))
    with torch.no_grad():
        a, _ = model(*args)
        model.rel_bias0[:, 0] += 8.0
        b, _ = model(*args)
    assert float((a - b).abs().max()) > 1e-4
