"""The unsupervised path's modules on the CPU against the JAX package:
the classifier generator and the critic on converted weights, the
WGAN-GP / bce critic losses and their critic gradients through the
gradient penalty's double backward (JAX's interpolation draw fed in),
EODM's expected n-gram log-probabilities and loss with and without
chunking, the repeat merge, the segmental front, the n-gram tables and
label-free selection, and the ``prepare`` subcommands.

Sizes are small (hidden 16-32, V = 8, B <= 4, T <= 40); every JAX
function is jitted. Bars: classifier logits f32 1e-5, bf16 2e-2; critic
score f32 1e-5; loss values rtol 1e-5; critic gradients atol 1e-5 / rtol
1e-4; EODM value and gradient 1e-5; merge lengths exact, values and
gradient 1e-6; k-means, segment pooling and the mode filter equal;
selection score rtol 1e-6."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from uasr.config import ModelConfig as JaxModelConfig
from uasr.models import PhoneDiscriminator as JaxDisc
from uasr.models.models import build_model as jax_build_model
from uasr.ops import eodm as jeodm
from uasr.ops import lm as jlm
from uasr.ops import segment as jseg
from uasr.ops import wgan as jwgan
from uasr.tools import prepare as jprepare
from uasr_torch.config import ModelConfig
from uasr_torch.convert import critic_to_state_dict, flax_to_state_dict
from uasr_torch.models.models import (
    PhoneDiscriminator, build_discriminator, build_model, encoder_time_subsample,
)
from uasr_torch.ops import eodm, lm, segment, wgan
from uasr_torch.tools import prepare

V, D = 8, 12
CLS = dict(encoder="classifier", classifier_hidden=32, classifier_layers=2, classifier_context=2,
           disc_channels=16, disc_layers=2, disc_kernel=5)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(x, dtype=torch.float32):
    return torch.tensor(np.asarray(x), dtype=dtype)


def _probs(rng, B, T, runs=False):
    """Posteriors [B, T, V]; with ``runs`` the argmax comes in runs of
    equal ids (blank included), as a generator's stream does."""
    logits = rng.randn(B, T, V).astype(np.float32)
    if runs:
        ids = np.repeat(rng.randint(0, V, (B, T // 3 + 1)), 3, axis=1)[:, :T]
        logits[np.arange(B)[:, None], np.arange(T)[None], ids] += 4.0
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


# ------------------------------------------------------------------ models


@pytest.fixture(scope="module")
def generator():
    """Seeded flax classifier weights, and the port's classifier on them
    in f32 and bf16."""
    rng = np.random.RandomState(0)
    feats = rng.randn(3, 23, D).astype(np.float32)
    lengths = np.array([23, 17, 4], np.int32)
    out = {}
    for dtype in ("float32", "bfloat16"):
        jm = jax_build_model(JaxModelConfig(dtype=dtype, **CLS), V)
        params = jm.init(jax.random.PRNGKey(1), feats, lengths)
        cfg = ModelConfig(dtype=dtype, **CLS)
        model = build_model(cfg, V, D, device="cpu")
        model.load_state_dict(flax_to_state_dict(_np(params), cfg))
        out[dtype] = (jm, params, model)
    return out, feats, lengths


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_classifier_matches_flax(generator, dtype, tol):
    models, feats, lengths = generator
    jm, params, model = models[dtype]
    jl, jn = jax.jit(jm.apply)(params, feats, lengths)
    with torch.no_grad():
        tl, tn = model(_t(feats), _t(lengths, torch.long))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    assert tl.dtype == torch.float32 and tl.shape == jl.shape
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=tol)
    assert encoder_time_subsample(model.cfg) == 1


@pytest.fixture(scope="module")
def critic():
    """Seeded flax critic weights (3 layers, kernel 5: odd and even
    lengths at every layer) and the port's critic on them."""
    cfg = dict(CLS, disc_layers=3)
    jd = JaxDisc(JaxModelConfig(**cfg))
    params = jd.init(jax.random.PRNGKey(2), np.zeros((2, 16, V), np.float32),
                     np.array([16, 9], np.int32))
    disc = build_discriminator(ModelConfig(**cfg), V, device="cpu")
    disc.load_state_dict(critic_to_state_dict(_np(params), ModelConfig(**cfg)))
    return jd, params, disc


@pytest.mark.parametrize("T", [21, 22])
def test_critic_matches_flax_at_odd_and_even_length(critic, T):
    jd, params, disc = critic
    rng = np.random.RandomState(T)
    probs = _probs(rng, 4, T)
    lengths = np.array([T, T - 1, 5, 1], np.int32)
    want = jax.jit(jd.apply)(params, probs, lengths)
    with torch.no_grad():
        got = disc(_t(probs), _t(lengths, torch.long))
    assert got.shape == (4,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_critic_stays_f32_and_bridge_names_match(critic):
    jd, params, disc = critic
    bf = build_discriminator(dataclasses.replace(disc.cfg, dtype="bfloat16"), V, device="cpu")
    bf.load_state_dict(disc.state_dict())
    x, n = torch.rand(2, 10, V), torch.tensor([10, 3])
    with torch.no_grad():
        assert torch.equal(bf(x, n), disc(x, n))
    assert set(critic_to_state_dict(_np(params), disc.cfg)) == set(disc.state_dict())
    assert isinstance(disc, PhoneDiscriminator)


# ---------------------------------------------------------------- WGAN-GP


@pytest.fixture(scope="module")
def gan_case(critic):
    """Real one-hot text and fake posteriors of different lengths, and
    JAX's interpolation draw for one rng key."""
    jd, params, disc = critic
    rng = np.random.RandomState(5)
    real = np.eye(V, dtype=np.float32)[rng.randint(1, V, (4, 14))]
    rlen = np.array([14, 9, 12, 3], np.int32)
    fake = _probs(rng, 4, 19)
    flen = np.array([19, 19, 7, 11], np.int32)
    key = jax.random.PRNGKey(7)
    eps = np.asarray(jax.random.uniform(key, (4, 1, 1), dtype=jnp.float32))
    return jd, params, disc, (real, rlen, fake, flen), key, eps


def _port_loss(name, disc, case, eps, params):
    real, rlen, fake, flen = case

    def d(x, n):
        return torch.func.functional_call(disc, params, (x, n))

    if name == "gradient_penalty":
        T = max(real.shape[1], fake.shape[1])
        pr = np.pad(real, ((0, 0), (0, T - real.shape[1]), (0, 0)))
        pf = np.pad(fake, ((0, 0), (0, T - fake.shape[1]), (0, 0)))
        return wgan.gradient_penalty(d, _t(pr), _t(pf), torch.minimum(
            _t(rlen, torch.long), _t(flen, torch.long)), eps=_t(eps)), {}
    fn = getattr(wgan, name)
    return fn(d, _t(real), _t(rlen, torch.long), _t(fake), _t(flen, torch.long), 10.0,
              eps=_t(eps))


def _jax_loss(name, jd, case, key):
    real, rlen, fake, flen = case
    if name == "gradient_penalty":
        T = max(real.shape[1], fake.shape[1])
        pr = jnp.pad(real, ((0, 0), (0, T - real.shape[1]), (0, 0)))
        pf = jnp.pad(fake, ((0, 0), (0, T - fake.shape[1]), (0, 0)))
        return lambda p: (jwgan.gradient_penalty(jd.apply, p, pr, pf,
                                                 jnp.minimum(rlen, flen), key), {})
    fn = getattr(jwgan, name)
    return lambda p: fn(jd.apply, p, real, rlen, fake, flen, 10.0, key)


@pytest.mark.parametrize("name", ["gradient_penalty", "d_loss_fn", "bce_d_loss_fn"])
def test_critic_losses_and_double_backward_match_jax(gan_case, name):
    jd, jparams, disc, case, key, eps = gan_case
    jfn = _jax_loss(name, jd, case, key)
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(jfn, has_aux=True))(jparams)
    params = {k: v.detach().clone().requires_grad_() for k, v in disc.named_parameters()}
    loss, aux = _port_loss(name, disc, case, eps, params)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    for k, v in jaux.items():
        np.testing.assert_allclose(aux[k].item(), float(v), rtol=1e-5, atol=1e-7, err_msg=k)
    # the penalty alone does not reach the score's bias: a zero gradient
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()), allow_unused=True,
                                                 materialize_grads=True)))
    want = critic_to_state_dict(_np(jgrads), disc.cfg)
    for k, g in want.items():
        np.testing.assert_allclose(grads[k].numpy(), g.numpy(), atol=1e-5, rtol=1e-4, err_msg=k)


def test_generator_losses_and_seeded_eps():
    s = torch.tensor([0.3, -1.2, 2.0])
    np.testing.assert_allclose(float(wgan.g_loss_fn(s)), float(jwgan.g_loss_fn(s.numpy())),
                               rtol=1e-6)
    np.testing.assert_allclose(float(wgan.bce_g_loss_fn(s)),
                               float(jwgan.bce_g_loss_fn(jnp.asarray(s.numpy()))), rtol=1e-6)
    a = wgan.draw_eps(4, torch.Generator().manual_seed(3), "cpu")
    b = wgan.draw_eps(4, torch.Generator().manual_seed(3), "cpu")
    assert a.shape == (4, 1, 1) and torch.equal(a, b) and bool(((a >= 0) & (a < 1)).all())


# ------------------------------------------------------------------- EODM


@pytest.fixture(scope="module")
def eodm_case():
    rng = np.random.RandomState(3)
    logits = (2.0 * rng.randn(3, 17, V)).astype(np.float32)
    lengths = np.array([17, 10, 2], np.int32)
    text = [list(rng.randint(1, V, rng.randint(3, 12))) for _ in range(40)]
    tables = [jeodm.build_ngram_table(text, n, k) for n, k in ((1, 6), (2, 11), (3, 9))]
    return logits, lengths, text, tables


def test_ngram_tables_equal_jax(eodm_case, tmp_path):
    _, _, text, tables = eodm_case
    for n, k in ((1, 6), (2, 11), (3, 9)):
        ours, ref = eodm.build_ngram_table(text, n, k), tables[n - 1]
        np.testing.assert_array_equal(ours.ids, ref.ids)
        np.testing.assert_array_equal(ours.probs, ref.probs)
        assert ours.order == n
    eodm.save_ngram_tables(str(tmp_path / "t.npz"), [eodm.NgramTable(*t) for t in tables])
    back = jeodm.load_ngram_tables(str(tmp_path / "t.npz"), [2, 3])
    np.testing.assert_array_equal(back[0].ids, tables[1].ids)
    with pytest.raises(ValueError, match="no order-4"):
        eodm.load_ngram_tables(str(tmp_path / "t.npz"), [4])


@pytest.mark.parametrize("k_chunk", [0, 4])
def test_eodm_value_and_gradient_match_jax(eodm_case, k_chunk):
    logits, lengths, _, tables = eodm_case
    jt = [(jnp.asarray(t.ids), jnp.asarray(t.probs)) for t in tables]
    tt = [(_t(t.ids, torch.long), _t(t.probs)) for t in tables]
    probs = jax.nn.softmax(logits, -1)
    for (ji, _), (ti, _) in zip(jt, tt):
        want = jax.jit(lambda p, n, i: jeodm.expected_ngram_logprobs(p, n, i, k_chunk=k_chunk))(
            probs, lengths, ji)
        got = eodm.expected_ngram_logprobs(torch.softmax(_t(logits), -1),
                                           _t(lengths, torch.long), ti, k_chunk=k_chunk)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda x: jeodm.eodm_loss(x, lengths, jt, k_chunk=k_chunk)))(logits)
    x = _t(logits).requires_grad_()
    loss = eodm.eodm_loss(x, _t(lengths, torch.long), tt, k_chunk=k_chunk)
    (g,) = torch.autograd.grad(loss, x)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=0, atol=1e-5)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=0, atol=1e-5)


# ------------------------------------------------------------ merge, segment


@pytest.mark.parametrize("blank", [0, 3])
def test_merge_repeats_matches_jax(blank):
    rng = np.random.RandomState(blank)
    probs = _probs(rng, 4, 30, runs=True)
    lengths = np.array([30, 21, 5, 0], np.int32)
    w = rng.randn(4, 30, V).astype(np.float32)

    def jf(p):
        pooled, n = jseg.merge_repeats_drop_blank(p, lengths, blank)
        return jnp.sum(pooled * w), (pooled, n)

    (_, (jp, jn)), jg = jax.jit(jax.value_and_grad(jf, has_aux=True))(probs)
    x = _t(probs).requires_grad_()
    pooled, n = segment.merge_repeats_drop_blank(x, _t(lengths, torch.long), blank)
    (g,) = torch.autograd.grad(torch.sum(pooled * _t(w)), x)
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
    assert int(n.max()) > 1
    # boundaries: each kept segment's argmax, and the zero rows past it
    for b in range(4):
        k = int(n[b])
        np.testing.assert_array_equal(pooled[b, :k].argmax(-1).numpy(),
                                      np.asarray(jp)[b, :k].argmax(-1))
    np.testing.assert_array_equal((pooled.detach() != 0).numpy(), np.asarray(jp) != 0)
    np.testing.assert_allclose(pooled.detach().numpy(), np.asarray(jp), rtol=0, atol=1e-6)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=0, atol=1e-6)


def test_kmeans_segment_pool_and_mode_filter_equal_jax():
    rng = np.random.RandomState(4)
    pts = rng.randn(120, 5).astype(np.float32)
    np.testing.assert_array_equal(segment.kmeans_fit(pts, 6, iters=8, seed=1),
                                  jseg.kmeans_fit(pts, 6, iters=8, seed=1))
    np.testing.assert_array_equal(segment.kmeans_fit(pts[:4], 6, iters=3),
                                  jseg.kmeans_fit(pts[:4], 6, iters=3))
    feats = rng.randn(3, 25, D).astype(np.float32)
    lengths = np.array([25, 14, 3], np.int32)
    ids = np.repeat(rng.randint(0, 5, (3, 9)), 3, axis=1)[:, :25]
    ids[:, ::7] = rng.randint(0, 5, ids[:, ::7].shape)  # blips
    for S in (None, 6):
        jp, jn = jax.jit(jseg.segment_pool, static_argnums=3)(feats, lengths, ids, S)
        tp, tn = segment.segment_pool(_t(feats), _t(lengths, torch.long), _t(ids, torch.long), S)
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    for radius, lens in ((0, None), (2, None), (2, lengths), (3, lengths)):
        want = jseg.mode_filter(jnp.asarray(ids), 5, radius,
                                lengths=None if lens is None else jnp.asarray(lens))
        got = segment.mode_filter(_t(ids, torch.long), 5, radius,
                                  lengths=None if lens is None else _t(lens, torch.long))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(segment.smooth_ids(_t(ids, torch.long)).numpy(),
                                  np.asarray(jseg.smooth_ids(jnp.asarray(ids))))
    cents = jseg.kmeans_fit(feats.reshape(-1, D), 4, iters=5)
    np.testing.assert_array_equal(segment.quantize(_t(feats), _t(cents)).numpy(),
                                  np.asarray(jseg.quantize(feats, cents)))
    for radius in (0, 2):
        jp, jn = jax.jit(jseg.kmeans_segment_frontend, static_argnums=(3, 4, 5))(
            feats, lengths, cents, 10, 2, radius)
        tp, tn = segment.kmeans_segment_frontend(_t(feats), _t(lengths, torch.long), _t(cents),
                                                 10, mode_radius=radius)
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=1e-6)


# ------------------------------------------------------- LM and selection


def test_lm_tables_and_selection_score_match_jax(tmp_path):
    rng = np.random.RandomState(6)
    text = [list(rng.randint(1, V, rng.randint(2, 9))) for _ in range(30)]
    hyps = np.zeros((6, 9), np.int32)
    lens = rng.randint(0, 10, 6)
    for i, n in enumerate(lens):
        hyps[i, :n] = rng.randint(1, V, n)
    for build in ("build_bigram_lm", "build_trigram_lm", "build_unigram"):
        np.testing.assert_array_equal(getattr(lm, build)(text, V, exclude=(0,)),
                                      getattr(jlm, build)(text, V, exclude=(0,)))
    uni = lm.build_unigram(text, V, exclude=(0,))
    for table in (lm.build_bigram_lm(text, V, exclude=(0,)),
                  lm.build_trigram_lm(text, V, exclude=(0,))):
        for cov in (0.0, 1.0):
            got = lm.unsup_selection_score(hyps, lens, table, uni, 0.7, coverage_weight=cov)
            want = jlm.unsup_selection_score(hyps, lens, table, uni, 0.7, coverage_weight=cov)
            assert got.keys() == want.keys() and got["tokens"] == want["tokens"]
            np.testing.assert_allclose(got["score"], want["score"], rtol=1e-6)
        np.testing.assert_allclose(lm.sequence_logprob(table, hyps[0, :lens[0]]),
                                   jlm.sequence_logprob(table, hyps[0, :lens[0]]), rtol=1e-6)
    assert lm.unsup_selection_score(hyps, np.zeros(6, int), table, uni)["score"] == -1e9
    path = str(tmp_path / "lm.npz")
    lm.save_lm(path, table, unigram=uni)
    np.testing.assert_array_equal(jlm.load_lm(path), table)
    np.testing.assert_array_equal(lm.load_unigram(path), uni)
    lm.save_lm(path, table)
    assert lm.load_unigram(path) is None


def test_prepare_ngrams_and_lm_equal_jax_tool(tmp_path):
    rng = np.random.RandomState(8)
    (tmp_path / "vocab.txt").write_text("\n".join(f"p{i}" for i in range(6)) + "\n")
    (tmp_path / "text.txt").write_text("\n".join(
        " ".join(f"p{i}" for i in rng.randint(0, 6, rng.randint(2, 10))) for _ in range(50)))
    common = ["--text", str(tmp_path / "text.txt"), "--vocab", str(tmp_path / "vocab.txt")]
    for tool, tag in ((prepare, "t"), (jprepare, "j")):
        tool.main(["ngrams", *common, "--orders", "1,2,3", "--top-k", "20",
                   "--out", str(tmp_path / f"ng_{tag}.npz")])
        tool.main(["lm", *common, "--order", "3", "--out", str(tmp_path / f"lm_{tag}.npz")])
    for name in ("ng", "lm"):
        a, b = np.load(tmp_path / f"{name}_t.npz"), np.load(tmp_path / f"{name}_j.npz")
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{name}/{k}")
