"""The port's grouped GRU recurrence (K5's plain version,
uasr_torch.models.cuda_gru.gru_scan_reference), its GRULayer and the causal
recurrent encoders UniGRUEncoder and LCBiGRUEncoder against the JAX package
on the CPU, on weights converted from flax (uasr_torch.convert).

K5's plain version is held against pallas_gru_scan in interpret mode (f32
1e-5, bf16 0.02); GRULayer (reverse, h0 with return_final) against
uasr.models.layers.GRULayer (f32 1e-5); the encoders' offline call and
chunked step, carry included, against the JAX encoders with
gru_pallas=False (their lax.scan), the port's K5 path running its plain
version (logits f32 1e-4, bf16 5e-2). Then the counterparts of the JAX
package's padding and chunked-step tests, and the bf16 gap between the
streamed (h0: gates in bf16) and offline (K5: gates in f32) recurrences,
which the JAX package has too."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from uasr.config import ModelConfig as JaxModelConfig
from uasr.models.layers import GRULayer as JaxGRULayer
from uasr.models.models import build_model as jax_build_model
from uasr.models.models import lc_initial_carry as jax_lc_carry
from uasr.models.models import uni_gru_initial_carry as jax_uni_carry
from uasr.models.pallas_gru import pallas_gru_scan
from uasr_torch.config import ModelConfig
from uasr_torch.convert import flax_to_state_dict
from uasr_torch.models import cuda_gru
from uasr_torch.models.layers import GRULayer
from uasr_torch.models.models import build_model, lc_initial_carry, uni_gru_initial_carry

D, V = 12, 7
TOL = {"float32": 1e-4, "bfloat16": 5e-2}
DT = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


# ---------------------------------------------------------------- K5


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 0.02)])
@pytest.mark.parametrize("T,G,B,H", [(1, 1, 3, 8), (9, 1, 4, 16), (7, 2, 5, 24), (12, 2, 1, 8)])
def test_gru_scan_reference_matches_pallas(T, G, B, H, dtype, tol):
    """Mixed lengths per group, a row of length 0, T = 1."""
    tdt, jdt = DT[dtype]
    rng = np.random.RandomState(T * G + B)
    xp = (0.5 * rng.randn(T, G, B, 3 * H)).astype(np.float32)
    wh = (rng.randn(G, H, 3 * H) / np.sqrt(H)).astype(np.float32)
    bh = (0.1 * rng.randn(G, 3 * H)).astype(np.float32)
    lengths = rng.randint(0, T + 1, (G, B))
    lengths[0, 0] = T
    lengths[-1, -1] = 0
    tmask = (np.arange(T)[:, None, None] < lengths[None]).astype(np.float32)
    want = pallas_gru_scan(jnp.asarray(xp, jdt), jnp.asarray(wh, jdt), jnp.asarray(bh, jdt),
                           jnp.asarray(tmask), True)
    got = cuda_gru.gru_scan(torch.tensor(xp).to(tdt), torch.tensor(wh).to(tdt),
                            torch.tensor(bh).to(tdt), torch.tensor(tmask) > 0)
    assert got.dtype == tdt and got.shape == (T, G, B, H)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=0,
                               atol=tol)
    assert not got.permute(1, 2, 0, 3)[torch.tensor(lengths == 0)].any()


# ---------------------------------------------------------------- GRULayer


def _layer_pair(reverse, seed=0, H=16, Din=12):
    rng = np.random.RandomState(seed)
    x = rng.randn(3, 10, Din).astype(np.float32)
    lengths = np.array([10, 6, 0], np.int32)
    jl = JaxGRULayer(H, reverse=reverse)
    params = jl.init(jax.random.PRNGKey(seed), x, lengths)
    layer = GRULayer(Din, H, reverse=reverse)
    layer.load_state_dict({k: torch.tensor(np.asarray(v))
                           for k, v in params["params"].items()})
    return jl, params, layer, x, lengths, rng


@pytest.mark.parametrize("use_pallas", [False, True], ids=["scan", "k5"])
@pytest.mark.parametrize("reverse", [False, True])
def test_gru_layer_matches_flax(reverse, use_pallas):
    jl, params, layer, x, lengths, _ = _layer_pair(reverse)
    layer.use_pallas = use_pallas
    want = jax.jit(jl.apply)(params, x, lengths)
    with torch.no_grad():
        got = layer(torch.tensor(x), torch.tensor(lengths, dtype=torch.long))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    assert not got[2].any() and not got[1, 6:].any()


def test_gru_layer_h0_return_final_matches_flax():
    jl, params, layer, x, lengths, rng = _layer_pair(False, seed=1)
    h0 = (0.5 * rng.randn(3, 16)).astype(np.float32)
    want, want_h = jax.jit(lambda p, a, n, h: jl.apply(p, a, n, h0=h, return_final=True))(
        params, x, lengths, h0)
    layer.use_pallas = True  # h0 takes the step loop, as in the JAX package
    with torch.no_grad():
        got, got_h = layer(torch.tensor(x), torch.tensor(lengths, dtype=torch.long),
                           h0=torch.tensor(h0), return_final=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got_h[2].numpy(), h0[2], rtol=0, atol=0)  # length 0: frozen
    with pytest.raises(ValueError, match="reverse"):
        GRULayer(12, 16, reverse=True)(torch.tensor(x), torch.tensor(lengths), h0=torch.zeros(3, 16))


# ---------------------------------------------------------------- encoders


def _models(encoder, dtype, T=48, seed=0, **extra):
    kw = dict(encoder=encoder, hidden_size=16, num_gru_layers=2, dtype=dtype, **extra)
    if encoder == "lc_bigru":
        kw = dict(lc_chunk=4, lc_lookahead=2, **kw)
    rng = np.random.RandomState(seed)
    feats = rng.randn(3, T, D).astype(np.float32)
    lengths = np.array([T, T - 13, 7], np.int32)
    jmodel = jax_build_model(JaxModelConfig(**kw), V)
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(seed), feats, lengths))
    cfg = ModelConfig(gru_pallas=True, **kw)
    model = build_model(cfg, V, D, device="cpu")
    model.load_state_dict(flax_to_state_dict(params, cfg))
    return jmodel, params, model, feats, lengths, cfg


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("encoder,T", [("uni_gru", 48), ("uni_gru", 45), ("lc_bigru", 48),
                                       ("lc_bigru", 53)])
def test_encoder_matches_flax(encoder, T, dtype):
    jmodel, params, model, feats, lengths, _ = _models(encoder, dtype, T)
    jl, jn = jax.jit(jmodel.apply)(params, feats, lengths)
    before = cuda_gru.LAUNCHES_GRU
    with torch.no_grad():
        tl, tn = model(torch.tensor(feats), torch.tensor(lengths, dtype=torch.long))
    assert cuda_gru.LAUNCHES_GRU == before  # CPU tensors: K5's plain version
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    assert tl.dtype == torch.float32 and tl.shape == jl.shape
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=TOL[dtype])


def test_state_dict_keys_match_bridge():
    for enc in ("uni_gru", "lc_bigru"):
        _, params, model, _, _, cfg = _models(enc, "float32")
        bridged = flax_to_state_dict(params, cfg)
        assert set(bridged) == set(model.state_dict())
        assert {"embed.weight", "context_ln.weight", "logits.bias"} <= set(bridged)
        for k, v in bridged.items():
            assert tuple(v.shape) == tuple(model.state_dict()[k].shape), k


def _uni_steps(step, carry, feats, lengths, C, torch_side):
    got = []
    for s in range(0, feats.shape[1], C):
        fv = np.clip(lengths - s, 0, C)
        if torch_side:
            with torch.no_grad():
                logits, carry = step(torch.tensor(feats[:, s:s + C]),
                                     torch.tensor(fv, dtype=torch.long), carry)
            got.append(logits.float().numpy())
        else:
            logits, carry = step(feats[:, s:s + C], fv, carry)
            got.append(np.asarray(logits, np.float32))
    return np.concatenate(got, 1), carry


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_uni_gru_step_matches_flax(dtype):
    """Chunked step with the carried state (conv tail, per-layer h) against
    the JAX step, chunk by chunk, carry included."""
    jmodel, params, model, feats, lengths, cfg = _models("uni_gru", dtype)
    C = 16
    jstep = jax.jit(lambda f, fv, c: jmodel.apply(params, f, fv, c, method="step"))
    want, jc = _uni_steps(jstep, jax_uni_carry(JaxModelConfig(**_kw(cfg)), 3), feats, lengths,
                          C, False)
    got, tc = _uni_steps(model.step, uni_gru_initial_carry(cfg, 3), feats, lengths, C, True)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL[dtype])
    for a, b in zip(tc, jc):
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b, np.float32), rtol=0,
                                   atol=TOL[dtype])


def _kw(cfg):
    keys = ("encoder", "hidden_size", "num_gru_layers", "dtype", "lc_chunk", "lc_lookahead")
    return {k: getattr(cfg, k) for k in keys}


def _lc_steps(step, carry, feats, lengths, C, torch_side, extra_chunks):
    """Feed whole chunks then ``extra_chunks`` zero chunks (the flush)."""
    B, T, Dd = feats.shape
    n = -(-T // C) + extra_chunks
    padded = np.zeros((B, n * C, Dd), np.float32)
    padded[:, :T] = feats
    got = []
    for c in range(n):
        a = np.full((B,), c * C)
        if torch_side:
            with torch.no_grad():
                logits, carry = step(torch.tensor(padded[:, c * C:(c + 1) * C]),
                                     torch.tensor(a), torch.tensor(lengths, dtype=torch.long),
                                     carry)
            got.append(logits.float().numpy())
        else:
            logits, carry = step(padded[:, c * C:(c + 1) * C], a, lengths, carry)
            got.append(np.asarray(logits, np.float32))
    return np.concatenate(got, 1), carry


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lc_bigru_step_matches_flax(dtype):
    """The latency-controlled step (backward windows through K5's plain
    version, forward state carried) against the JAX step, carry (tail,
    buffers, forward states) included, and, shifted by the layer delay,
    against the offline call."""
    jmodel, params, model, feats, lengths, cfg = _models("lc_bigru", dtype, T=56)
    C = cfg.lc_chunk * 4
    L = cfg.num_gru_layers
    jstep = jax.jit(lambda f, a, v, c: jmodel.apply(params, f, a, v, c, method="step"))
    want, jc = _lc_steps(jstep, jax_lc_carry(JaxModelConfig(**_kw(cfg)), 3), feats, lengths, C,
                         False, L)
    got, tc = _lc_steps(model.step, lc_initial_carry(cfg, 3), feats, lengths, C, True, L)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL[dtype])
    flat = lambda c: [c[0], *c[1], *c[2]]  # noqa: E731
    for a, b in zip(flat(tc), flat(jc)):
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b, np.float32), rtol=0,
                                   atol=TOL[dtype])
    with torch.no_grad():
        off, n = model(torch.tensor(feats), torch.tensor(lengths, dtype=torch.long))
    lag = L * cfg.lc_chunk
    for b in range(3):
        k = int(n[b])
        np.testing.assert_allclose(got[b, lag:lag + k], off[b, :k].numpy(), rtol=0,
                                   atol=TOL[dtype])


@pytest.mark.parametrize("encoder", ["uni_gru", "lc_bigru"])
def test_recurrent_padding_invariance(encoder):
    """Counterparts of tests/test_models.py's uni_gru and lc_bigru padding
    tests: extending batch padding leaves every valid frame unchanged."""
    _, _, model, feats, lengths, _ = _models(encoder, "float32")
    lens = torch.tensor(lengths, dtype=torch.long)
    padded = np.pad(feats, ((0, 0), (0, 32), (0, 0)))
    with torch.no_grad():
        a, la = model(torch.tensor(feats), lens)
        b, lb = model(torch.tensor(padded), lens)
    np.testing.assert_array_equal(la.numpy(), lb.numpy())
    for i, t in enumerate(la.tolist()):
        np.testing.assert_allclose(a[i, :t].numpy(), b[i, :t].numpy(), rtol=0, atol=3e-5)


def test_uni_gru_chunked_step_matches_offline_call():
    """Counterpart of tests/test_models.py's streaming-seam test: chunks
    through step with the carried state reproduce the offline call,
    streams ending mid-chunk and chunk-aligned included."""
    _, _, model, feats, _, cfg = _models("uni_gru", "float32")
    lengths = np.array([48, 23, 7], np.int32)
    with torch.no_grad():
        off, n = model(torch.tensor(feats), torch.tensor(lengths, dtype=torch.long))
    got, _ = _uni_steps(model.step, uni_gru_initial_carry(cfg, 3), feats, lengths, 16, True)
    for b in range(3):
        k = int(n[b])
        np.testing.assert_allclose(got[b, :k], off[b, :k].numpy(), rtol=0, atol=1e-5)


def test_lc_bigru_bounded_context():
    """Counterpart of tests/test_models.py's lc_bigru test: perturbing the
    last patch leaves every chunk whose compounded windows cannot reach it
    bit-unchanged, and does reach the final region."""
    kw = dict(num_gru_layers=2, lc_chunk=4, lc_lookahead=2)
    cfg = ModelConfig(encoder="lc_bigru", hidden_size=16, gru_pallas=True, **kw)
    model = build_model(cfg, V, D, generator=torch.Generator().manual_seed(1), device="cpu")
    feats = torch.tensor(np.random.RandomState(1).randn(1, 96, D).astype(np.float32))
    lengths = torch.tensor([96])
    pert = feats.clone()
    pert[:, -4:] += 10.0
    with torch.no_grad():
        a, _ = model(feats, lengths)
        c, _ = model(pert, lengths)
    n_patches = 24
    last_safe = (n_patches - 1 - cfg.lc_lookahead) // cfg.lc_chunk - cfg.num_gru_layers
    safe_upto = (last_safe + 1) * cfg.lc_chunk
    assert safe_upto >= 8
    assert torch.equal(a[0, :safe_upto], c[0, :safe_upto])
    assert float((a[0, -1] - c[0, -1]).abs().max()) > 1e-3


def test_bf16_streamed_step_and_offline_kernel_differ():
    """With an h0 the GRU step loop runs its gates in bf16 (the JAX
    package's lax.scan branch); K5 and its plain version run them in f32.
    In bf16 the streamed and offline uni_gru are therefore different
    functions, in the JAX package too (ROADMAP.md Queue 3). The gap is
    measured here: both within the bf16 logits bar of the f32 model, and
    apart from each other by more than f32 noise."""
    _, params, model, feats, lengths, cfg = _models("uni_gru", "bfloat16", T=64)
    f32 = build_model(ModelConfig(**{**_kw(cfg), "dtype": "float32", "gru_pallas": True}), V, D,
                      device="cpu")
    f32.load_state_dict(model.state_dict())
    lens = torch.tensor(lengths, dtype=torch.long)
    with torch.no_grad():
        off, n = model(torch.tensor(feats), lens)
        ref, _ = f32(torch.tensor(feats), lens)
    got, _ = _uni_steps(model.step, uni_gru_initial_carry(cfg, 3), feats, lengths, 16, True)
    valid = np.arange(off.shape[1])[None, :] < n.numpy()[:, None]
    gap = float(np.abs(got - off.numpy())[valid].max())
    assert float((off - ref).abs().max()) <= 5e-2
    assert float(np.abs(got - ref.numpy())[valid].max()) <= 5e-2
    assert 1e-4 < gap <= 5e-2, gap
