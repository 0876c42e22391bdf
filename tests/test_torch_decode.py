"""The port's decoders (uasr_torch.ops) against the JAX package on the CPU:
greedy, K4's plain version through ctc_beam_search_decode against the
Pallas beam kernel in interpret mode and the exact XLA fold beam, with and
without bigram/trigram LM tables, and batch_edit_distance."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from uasr.ops.decode import ctc_beam_search_decode as jax_beam
from uasr.ops.decode import ctc_greedy_decode as jax_greedy
from uasr.ops.edit_distance import batch_edit_distance as jax_edit_distance
from uasr.ops.pallas_beam import ctc_beam_search_decode_pallas
from uasr_torch.ops import cuda_beam
from uasr_torch.ops.decode import ctc_beam_search_decode, ctc_greedy_decode
from uasr_torch.ops.edit_distance import batch_edit_distance


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
