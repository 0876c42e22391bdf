"""The port's decoders (uasr_torch.ops) against the JAX package on the CPU:
greedy, K4's plain version through ctc_beam_search_decode against the
Pallas beam kernel in interpret mode and the exact XLA fold beam, with and
without bigram/trigram LM tables, the carried beam state (chunks equal one
pass; the streaming beam_advance against the JAX package's), and
batch_edit_distance."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from uasr.ops.decode import ctc_beam_init as jax_beam_init
from uasr.ops.decode import ctc_beam_search_decode as jax_beam
from uasr.ops.decode import ctc_greedy_decode as jax_greedy
from uasr.ops.edit_distance import batch_edit_distance as jax_edit_distance
from uasr.ops.pallas_beam import ctc_beam_search_decode_pallas
from uasr.serve import beam_advance as jax_beam_advance
from uasr_torch.ops import cuda_beam
from uasr_torch.ops.decode import ctc_beam_search_decode, ctc_greedy_decode
from uasr_torch.ops.edit_distance import batch_edit_distance
from uasr_torch.serve import beam_advance


def _logits(seed, B=4, T=18, V=10, scale=2.0):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(B, T, V) * scale).astype(np.float32)
    lengths = np.array([T, T - 4, 7, 1][:B], np.int32)
    return logits, lengths, rng


def _lm(rng, order, V):
    shape = (V + 1,) if order == 2 else (V + 1, V + 1)
    return np.log(rng.dirichlet(np.ones(V), shape)).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_greedy_matches_jax(seed):
    logits, lengths, _ = _logits(seed)
    r_ids, r_len = jax_greedy(jnp.asarray(logits), jnp.asarray(lengths))
    ids, n = ctc_greedy_decode(torch.tensor(logits), torch.tensor(lengths, dtype=torch.long))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(r_ids))
    np.testing.assert_array_equal(n.numpy(), np.asarray(r_len))


@pytest.mark.parametrize("lm_order", [0, 2, 3], ids=["no_lm", "bigram", "trigram"])
@pytest.mark.parametrize("seed", [0, 1])
def test_beam_matches_pallas_and_xla_fold(seed, lm_order):
    logits, lengths, rng = _logits(seed)
    V, W = logits.shape[-1], 8
    lm = _lm(rng, lm_order, V) if lm_order else None
    kw = dict(lm_weight=0.5, lm_bonus=0.3)
    jlm = None if lm is None else jnp.asarray(lm)
    p_ids, p_len, p_sc = ctc_beam_search_decode_pallas(
        jnp.asarray(logits), jnp.asarray(lengths), beam_width=W, lm_logp=jlm,
        interpret=True, **kw)
    x_ids, x_len, x_sc = jax_beam(jnp.asarray(logits), jnp.asarray(lengths), beam_width=W,
                                  prune=V, merge_impl="fold", lm_logp=jlm, **kw)
    ids, n, sc = ctc_beam_search_decode(
        torch.tensor(logits), torch.tensor(lengths, dtype=torch.long), beam_width=W,
        lm_logp=None if lm is None else torch.tensor(lm), **kw)
    for r_ids, r_len, r_sc in ((p_ids, p_len, p_sc), (x_ids, x_len, x_sc)):
        np.testing.assert_array_equal(ids.numpy(), np.asarray(r_ids))
        np.testing.assert_array_equal(n.numpy(), np.asarray(r_len))
        np.testing.assert_allclose(sc.numpy(), np.asarray(r_sc), rtol=0, atol=1e-4)


def test_beam_nonzero_blank_few_candidates_matches_pallas():
    """blank_id != 0 with V < W: top-W runs out of live candidates, and the
    kernel's rounds then re-pick the lowest-index column; the plain
    version keeps that behaviour."""
    logits, lengths, _ = _logits(5, B=3, T=12, V=5, scale=3.0)
    p = ctc_beam_search_decode_pallas(jnp.asarray(logits), jnp.asarray(lengths),
                                      beam_width=8, blank_id=2, interpret=True)
    ids, n, sc = ctc_beam_search_decode(torch.tensor(logits),
                                        torch.tensor(lengths, dtype=torch.long),
                                        beam_width=8, blank_id=2)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(p[0]))
    np.testing.assert_array_equal(n.numpy(), np.asarray(p[1]))
    np.testing.assert_allclose(sc.numpy(), np.asarray(p[2]), rtol=0, atol=1e-4)


def test_beam_on_cpu_runs_plain_version():
    logits, lengths, _ = _logits(3)
    before = cuda_beam.LAUNCHES
    ctc_beam_search_decode(torch.tensor(logits), torch.tensor(lengths, dtype=torch.long), 4)
    assert cuda_beam.LAUNCHES == before
    with pytest.raises(ValueError, match="LM table shape"):
        ctc_beam_search_decode(torch.tensor(logits), torch.tensor(lengths), 4,
                               lm_logp=torch.zeros(3, 3))


def test_logaddexp_with_neg_is_identity():
    """logaddexp(x, NEG) and logaddexp(NEG, x) are x bit for bit, and NEG
    for x = NEG: K4 drops the NEG terms of its folds and the lae of a
    beam's new total on that identity."""
    rng = np.random.RandomState(0)
    x = torch.tensor(np.concatenate([rng.uniform(-1e4, 1.0, 4096), [cuda_beam.NEG]]),
                     dtype=torch.float32)
    neg = torch.full_like(x, cuda_beam.NEG)
    for got in (cuda_beam._logaddexp(x, neg), cuda_beam._logaddexp(neg, x)):
        assert torch.equal(got.view(torch.int32), x.view(torch.int32))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_left_fold_skips_neg_terms(seed):
    """A left fold of logaddexp over contributions that are mostly NEG
    equals the fold over only the others, in the same order (NEG if none):
    the sparse fold of K4's stays."""
    rng = np.random.RandomState(seed)
    N, W = 2048, 16
    vals = rng.uniform(-60.0, 0.0, (N, W)).astype(np.float32)
    vals[rng.rand(N, W) < 0.8] = cuda_beam.NEG
    c = torch.tensor(vals)
    dense = c[:, 0]
    for w in range(1, W):
        dense = cuda_beam._logaddexp(dense, c[:, w])
    for n in range(N):
        terms = [c[n, w] for w in range(W) if vals[n, w] != cuda_beam.NEG]
        sparse = terms[0] if terms else torch.tensor(cuda_beam.NEG, dtype=torch.float32)
        for t in terms[1:]:
            sparse = cuda_beam._logaddexp(sparse, t)
        assert sparse.view(torch.int32) == dense[n].view(torch.int32), n


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_edit_distance_matches_jax(seed):
    rng = np.random.RandomState(seed)
    B, N, M = 5, 9, 11
    refs = rng.randint(1, 6, (B, N)).astype(np.int32)
    hyps = rng.randint(0, 6, (B, M)).astype(np.int32)
    rl = np.array([9, 5, 0, 3, 1], np.int32)
    hl = np.array([11, 0, 4, 7, 1], np.int32)
    ref = jax_edit_distance(*(jnp.asarray(a) for a in (refs, rl, hyps, hl)))
    got = batch_edit_distance(*(torch.tensor(a, dtype=torch.long) for a in (refs, rl, hyps, hl)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_beam_init_matches_jax():
    j, t = jax_beam_init(3, 5), cuda_beam.beam_init(3, 5)
    for name, a, b in zip(t._fields, j, t):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a).astype(b.numpy().dtype),
                                      err_msg=name)


@pytest.mark.parametrize("lm_order", [0, 2])
@pytest.mark.parametrize("W,V", [(4, 10), (8, 8)])
def test_beam_steps_chunks_equal_one_pass(W, V, lm_order):
    """The recursion fed in chunks, each from the state the previous one
    left, gives one pass's bits: backpointers, and the state after each
    chunk (lengths end inside and before chunks)."""
    logits, lengths, rng = _logits(7, B=4, T=18, V=V)
    logp = torch.log_softmax(torch.tensor(logits), -1)
    lens = torch.tensor(lengths, dtype=torch.long)
    lm = torch.tensor(_lm(rng, lm_order, V)) if lm_order else None
    kw = dict(lm_table=lm, lm_order=lm_order, lm_weight=0.5, lm_bonus=0.3)
    p1, c1, s1 = cuda_beam.ctc_beam_steps(logp, lens, W, 0, **kw)
    state, parts = None, []
    for a, b in ((0, 5), (5, 6), (6, 18)):
        p, c, state = cuda_beam.ctc_beam_steps(logp[:, a:b].contiguous(),
                                               torch.clamp(lens - a, min=0), W, 0,
                                               state=state, **kw)
        parts.append((p, c))
    assert torch.equal(torch.cat([p for p, _ in parts]), p1)
    assert torch.equal(torch.cat([c for _, c in parts]), c1)
    for name, a, b in zip(s1._fields, s1, state):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("W,V", [(8, 8), (4, 40), (8, 300)])
def test_beam_advance_matches_jax(W, V):
    """The streaming beam over three chunks against the JAX package's
    beam_advance (ctc_beam_scan, exact candidate set): prefixes and their
    lengths bit-equal, p_b / p_nb to 1e-4."""
    B, K, L = 3, 6, 12
    rng = np.random.RandomState(V)
    logp = np.asarray(jax.nn.log_softmax(jnp.asarray(rng.randn(B, 3 * K, V) * 3.0), -1),
                      np.float32)
    ulen = np.array([3 * K, 2 * K - 2, 4])
    jb, jp, jl = jax_beam_init(B, W), jnp.full((B, W, L), -1, jnp.int32), jnp.zeros((B, W),
                                                                                    jnp.int32)
    tb, tp = cuda_beam.beam_init(B, W), torch.full((B, W, L), -1, dtype=torch.int32)
    tl = torch.zeros(B, W, dtype=torch.long)
    step = jax.jit(lambda b, p, n, x, m: jax_beam_advance(b, p, n, x, m, prune=V))
    for k in range(3):
        lp = logp[:, k * K:(k + 1) * K]
        lens = np.clip(ulen - k * K, 0, K)
        jb, jp, jl = step(jb, jp, jl, jnp.asarray(lp), jnp.asarray(lens))
        tb, tp, tl = beam_advance(tb, tp, tl, torch.tensor(lp), torch.tensor(lens))
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp), err_msg=f"chunk {k}")
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl), err_msg=f"chunk {k}")
        for name in ("p_b", "p_nb"):
            np.testing.assert_allclose(getattr(tb, name).numpy(), np.asarray(getattr(jb, name)),
                                       rtol=0, atol=1e-4, err_msg=f"chunk {k} {name}")
    # the best beam's prefix is the offline beam decode of the whole logp,
    # cut at the prefix cap L
    best = cuda_beam._logaddexp(tb.p_b, tb.p_nb).argmax(1)
    ids, n, _ = ctc_beam_search_decode(torch.tensor(logp), torch.tensor(ulen), W)
    for b in range(B):
        got = tp[b, best[b], : tl[b, best[b]]].tolist()
        assert got == ids[b, : min(int(n[b]), L)].tolist()
