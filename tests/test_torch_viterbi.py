"""The port's HMM Viterbi decode, CTC forced alignment, dwell-rate
calibration and ARPA import against the JAX package's on the same numpy
inputs, on the CPU.

Sizes are small (V = 6, B <= 4, T <= 16); every JAX decode is jitted once
per case in a module-scoped fixture. Bars: states, ids, lengths and frame
ids equal; path scores rtol 1e-5; HMM tables and ARPA tables byte-equal;
calibration statistics and rates equal. Cases: random logits with a
full-length, a length-1 and a zero-length row; T = 1; one-hot posteriors
(whole rows of tied paths) with the merged-stream rates (self_loop 0)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from uasr.config import CTCConfig as JaxCTCConfig
from uasr.ops import lm as jlm
from uasr.ops import viterbi as jv
from uasr_torch.config import CTCConfig
from uasr_torch.ops import lm as tlm
from uasr_torch.ops import viterbi as tv

V, BLANK = 6, 0


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this file: the suite runs files in parallel
    workers, and under that load each of the many small parallel ops here
    waits on every thread of an oversubscribed pool (tens of times slower)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _corpus(seed=0, n=40):
    rng = np.random.RandomState(seed)
    return [list(rng.randint(1, V, rng.randint(1, 8))) for _ in range(n)]


def _one_hot_logits(rng, B, T):
    """Posteriors that are one-hot runs of random symbols (blank among
    them): the HMM's paths tie across whole rows."""
    ids = np.repeat(rng.randint(0, V, (B, T // 2 + 1)), 2, axis=1)[:, :T]
    return (10.0 * np.eye(V, dtype=np.float32)[ids]).astype(np.float32)


def _cases():
    rng = np.random.RandomState(3)
    return {
        # (logits [B, T, V], lengths, self_loop, blank_prob)
        "random": ((2.0 * rng.randn(3, 16, V)).astype(np.float32), np.array([16, 1, 0]),
                   0.75, 0.1),
        "t1": ((2.0 * rng.randn(2, 1, V)).astype(np.float32), np.array([1, 0]), 0.75, 0.1),
        "ties": (_one_hot_logits(rng, 3, 16), np.array([16, 9, 16]), 0.0, 0.3),
    }


@pytest.fixture(scope="module")
def tables():
    seqs = _corpus()
    return {2: jlm.build_bigram_lm(seqs, V, exclude=(BLANK,)),
            3: jlm.build_trigram_lm(seqs, V, exclude=(BLANK,))}


@pytest.fixture(scope="module")
def jax_decodes(tables):
    """JAX's make_lm_decoder outputs for every case and table order."""
    out = {}
    for name, (logits, lengths, sl, bp) in _cases().items():
        for order, tab in tables.items():
            fn = jax.jit(jv.make_lm_decoder(tab, BLANK, self_loop=sl, blank_prob=bp))
            out[name, order] = [np.asarray(x) for x in fn(jnp.asarray(logits),
                                                           jnp.asarray(lengths))]
    return out


def test_lm_hmm_tables_byte_equal(tables):
    for sl, bp in ((0.75, 0.1), (0.0, 0.3), (0.95, 0.01)):
        for a, b in zip(tv.lm_hmm(tables[2], BLANK, sl, bp), jv.lm_hmm(tables[2], BLANK, sl, bp)):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        got = tv.trigram_hmm(tables[3], BLANK, sl, bp)
        ref = jv.trigram_hmm(tables[3], BLANK, sl, bp)
        assert set(got) == set(ref)
        assert (got["V"], got["blank_id"]) == (ref["V"], ref["blank_id"])
        for k in set(ref) - {"V", "blank_id"}:
            g, r = got[k].numpy(), np.asarray(ref[k])
            assert g.dtype == r.dtype and g.tobytes() == r.tobytes(), k
    with pytest.raises(ValueError, match="bigram"):
        tv.lm_hmm(tables[2][:-1], BLANK)
    with pytest.raises(ValueError, match="V\\+1, V\\+1, V"):
        tv.trigram_hmm(tables[3][:, :-1], BLANK)


@pytest.mark.parametrize("order", [2, 3], ids=["bigram", "trigram"])
@pytest.mark.parametrize("case", ["random", "t1", "ties"])
def test_viterbi_decode_matches_jax(tables, jax_decodes, case, order):
    logits, lengths, sl, bp = _cases()[case]
    fn = tv.make_lm_decoder(tables[order], BLANK, self_loop=sl, blank_prob=bp, device="cpu")
    ids, n, score = fn(torch.as_tensor(logits), torch.as_tensor(lengths))
    r_ids, r_n, r_score = jax_decodes[case, order]
    np.testing.assert_array_equal(n.numpy(), r_n)
    np.testing.assert_array_equal(ids.numpy(), r_ids)
    np.testing.assert_allclose(score.numpy(), r_score, rtol=1e-5)


def test_generic_viterbi_states_match_jax():
    """The dense-transition recursion's states on random emissions and a
    transition matrix with forbidden (-1e30) entries and tied rows."""
    rng = np.random.RandomState(5)
    S = 5
    emit = np.log(rng.dirichlet(np.ones(S), (2, 10))).astype(np.float32)
    trans = np.log(rng.dirichlet(np.ones(S), S)).astype(np.float32)
    trans[rng.rand(S, S) < 0.3] = jv.NEG
    trans[3] = trans[1]
    init = np.log(np.full(S, 1.0 / S)).astype(np.float32)
    lengths = np.array([10, 4])
    r_states, r_score = jax.jit(jv.viterbi_decode)(*map(jnp.asarray, (emit, lengths, init,
                                                                      trans)))
    states, score = tv.viterbi_decode(*map(torch.as_tensor, (emit, lengths, init, trans)))
    np.testing.assert_array_equal(states.numpy(), np.asarray(r_states))
    np.testing.assert_allclose(score.numpy(), np.asarray(r_score), rtol=1e-5)
    toks = tv.states_to_tokens(states, torch.as_tensor(lengths), 2, BLANK)
    r_toks = jv.states_to_tokens(r_states, jnp.asarray(lengths), 2, BLANK)
    for a, b in zip(toks, r_toks):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("ties", [False, True], ids=["random", "one_hot"])
def test_forced_align_matches_jax(ties):
    """Repeated labels (no skip between them), a zero-length transcript,
    and a transcript longer than its frames allow."""
    rng = np.random.RandomState(7)
    B, T = 4, 14
    logits = (_one_hot_logits(rng, B, T) if ties
              else (2.0 * rng.randn(B, T, V)).astype(np.float32))
    labels = np.array([[1, 1, 2, 3, 3], [2, 4, 0, 0, 0], [0, 0, 0, 0, 0], [1, 2, 3, 4, 5]])
    llen = np.array([5, 2, 0, 5])
    lengths = np.array([14, 9, 6, 3])
    r_ids, r_score = jax.jit(jv.ctc_forced_align)(*map(jnp.asarray,
                                                       (logits, lengths, labels, llen)))
    ids, score = tv.ctc_forced_align(*map(torch.as_tensor, (logits, lengths, labels, llen)))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(r_ids))
    np.testing.assert_allclose(score.numpy(), np.asarray(r_score), rtol=1e-5)
    assert (ids[2] == BLANK).all()


def test_rate_calibration_matches_jax():
    """greedy_path_stats and estimate_hmm_rates on a frame-level and a
    merged stream, and resolve_viterbi_rates' policy: defaults calibrate,
    pinned rates and viterbi_auto_rates off keep them, no probe batches
    keep the defaults."""
    rng = np.random.RandomState(9)
    frame = np.repeat(rng.randint(0, V, (2, 10)), 4, axis=1)  # 4-frame dwell
    merged = rng.randint(1, V, (2, 30))
    for ids in (frame, merged):
        logits = np.eye(V, dtype=np.float32)[ids]
        lengths = np.array([ids.shape[1], ids.shape[1] - 7])
        got = [int(x) for x in tv.greedy_path_stats(torch.as_tensor(logits),
                                                    torch.as_tensor(lengths), BLANK)]
        ref = [int(x) for x in jv.greedy_path_stats(jnp.asarray(logits),
                                                    jnp.asarray(lengths), BLANK)]
        assert got == ref
        assert tv.estimate_hmm_rates(*got) == jv.estimate_hmm_rates(*ref)

        def probe(b, arr=logits, n=lengths):
            return (torch.as_tensor(arr), torch.as_tensor(n))

        def jprobe(b, arr=logits, n=lengths):
            return (jnp.asarray(arr), jnp.asarray(n))

        for kw in ({}, dict(viterbi_self_loop=0.5), dict(viterbi_auto_rates=False)):
            got = tv.resolve_viterbi_rates(CTCConfig(**kw), probe, [0] * 6)
            from uasr.data.dataset import Batch

            jb = Batch(*(np.zeros((1, 1), np.float32),) * 4)
            ref = jv.resolve_viterbi_rates(JaxCTCConfig(**kw), jprobe, [jb] * 6)
            assert got == ref, kw
        assert tv.resolve_viterbi_rates(CTCConfig(), probe, []) == (0.75, 0.1, (
            "defaults (no probe batches available)"))
    assert dataclasses.asdict(CTCConfig())["viterbi_self_loop"] == (
        JaxCTCConfig.viterbi_self_loop)


ARPA_TRI = """\\data\\
ngram 1=5
ngram 2=4
ngram 3=2

\\1-grams:
-0.60206\ta\t-0.30103
-0.69897\tb\t-0.17609
-1.00000\tc
-0.90000\t<s>\t-0.20000
-1.30103\t</s>

\\2-grams:
-0.30103\ta b\t-0.10000
-0.52288\tb a
-0.39794\t<s> a\t-0.05000
-0.80000\tb c

\\3-grams:
-0.17609\ta b c
-0.45000\t<s> a b

\\end\\
"""


def test_arpa_tables_byte_equal(tmp_path):
    """Parse; the bigram and trigram backoff chains; a vocabulary token the
    ARPA lacks (finite, penalised); each table and unigram byte-equal."""
    path = tmp_path / "lm.arpa"
    path.write_text(ARPA_TRI)
    assert tlm.parse_arpa(str(path)) == jlm.parse_arpa(str(path))
    for tokens in (["<blk>", "a", "b", "c"], ["<blk>", "a", "b", "c", "zz"]):
        for order in (2, 3, None):
            got = tlm.load_arpa(str(path), tokens, order=order, exclude=(0,))
            ref = jlm.load_arpa(str(path), tokens, order=order, exclude=(0,))
            for a, b in zip(got, ref):
                assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
            assert np.isfinite(got[0]).all()
    logp, _ = tlm.load_arpa(str(path), ["<blk>", "a", "b", "c", "zz"], order=2, exclude=(0,))
    assert logp[1, 4] < logp[1, 2]


def test_arpa_order_errors(tmp_path):
    bi = tmp_path / "bi.arpa"
    bi.write_text(ARPA_TRI.split("\\3-grams:")[0] + "\\end\\\n")
    with pytest.raises(ValueError, match="only has 2-grams"):
        tlm.load_arpa(str(bi), ["a", "b"], order=3)
    with pytest.raises(ValueError, match="order 2 or 3"):
        tlm.arpa_to_table(tlm.parse_arpa(str(bi)), ["a", "b"], order=1)
    bad = tmp_path / "bad.arpa"
    bad.write_text("not an arpa file\n")
    with pytest.raises(ValueError, match="no n-gram"):
        tlm.load_arpa(str(bad), ["a", "b"])


@pytest.mark.parametrize("order", [None, 2], ids=["auto", "bigram"])
def test_prepare_import_arpa_matches_jax(tmp_path, order, capsys):
    from uasr.tools.prepare import main as jax_prepare
    from uasr_torch.tools.prepare import main as prepare

    arpa = tmp_path / "lm.arpa"
    arpa.write_text(ARPA_TRI)
    vocab = tmp_path / "vocab.txt"
    vocab.write_text("a\nb\nc\n")
    extra = [] if order is None else ["--order", str(order)]
    outs = []
    for fn, name in ((jax_prepare, "jax.npz"), (prepare, "torch.npz")):
        out = tmp_path / name
        fn(["import-arpa", "--arpa", str(arpa), "--vocab", str(vocab), "--out", str(out),
            *extra])
        with np.load(out) as z:
            outs.append({k: z[k] for k in z.files})
    assert outs[0].keys() == outs[1].keys() == {"logp", "unigram"}
    for k, ref in outs[0].items():
        assert outs[1][k].dtype == ref.dtype and outs[1][k].tobytes() == ref.tobytes(), k
    assert outs[1]["logp"].shape == ((5, 5, 4) if order is None else (5, 4))
