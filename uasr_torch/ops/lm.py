"""Token n-gram language model tables (counterpart of the parts of
``uasr.ops.lm`` that unsupervised model selection and ``prepare lm``
need; ARPA import is not ported yet, ROADMAP.md Queue 1, item 8).

The LM is a dense [V + 1, V] (bigram) or [V + 1, V + 1, V] (trigram)
table of log-probabilities: row ``h`` (0 <= h < V) is log P(next | prev =
h), and index V is the start of the sequence. Smoothing is add-k over the
vocabulary, so every transition stays finite. Host numpy throughout.
"""

from __future__ import annotations

import numpy as np


def build_bigram_lm(
    sequences,
    vocab_size: int,
    add_k: float = 0.5,
    exclude: tuple[int, ...] = (),
) -> np.ndarray:
    """Count-based add-k bigram LM -> [V + 1, V] float32 log-probs.

    sequences: iterable of int token id sequences (text corpus).
    exclude: token ids never emitted by the decoder (e.g. the CTC
    blank) — their COLUMNS get probability ~0 so smoothing mass is not
    wasted on them; their rows stay uniform (never consulted).
    """
    V = vocab_size
    counts = np.zeros((V + 1, V), np.float64)
    for seq in sequences:
        prev = V  # start-of-sequence row
        for tok in seq:
            t = int(tok)
            if not (0 <= t < V):
                continue
            counts[prev, t] += 1.0
            prev = t
    counts += add_k
    keep = np.ones(V, bool)
    for e in exclude:
        if 0 <= e < V:
            keep[e] = False
    counts[:, ~keep] = 1e-20
    logp = np.log(counts) - np.log(counts.sum(axis=1, keepdims=True))
    return logp.astype(np.float32)


def save_lm(path: str, logp: np.ndarray, unigram: np.ndarray | None = None
            ) -> None:
    payload = {"logp": logp}
    if unigram is not None:
        payload["unigram"] = unigram
    # write to the EXACT path given (np.savez appends '.npz' to bare
    # string paths, silently diverging from what configs reference)
    with open(path, "wb") as f:
        np.savez(f, **payload)


def load_lm(path: str) -> np.ndarray:
    with np.load(path) as z:
        return z["logp"].astype(np.float32)


def load_unigram(path: str) -> np.ndarray | None:
    with np.load(path) as z:
        if "unigram" not in z:
            return None
        return z["unigram"].astype(np.float32)


def build_trigram_lm(
    sequences,
    vocab_size: int,
    add_k: float = 0.5,
    exclude: tuple[int, ...] = (),
) -> np.ndarray:
    """Count-based add-k trigram LM -> [V + 1, V + 1, V] float32
    log-probs: row (h2, h1) = log P(next | prev2 = h2, prev = h1), with
    index V = start-of-sequence in either history slot. Dense is the
    right call at phoneme vocabulary sizes (V = 40: ~270 KB f32)."""
    V = vocab_size
    counts = np.zeros((V + 1, V + 1, V), np.float64)
    for seq in sequences:
        h2, h1 = V, V
        for tok in seq:
            t = int(tok)
            if not (0 <= t < V):
                continue
            counts[h2, h1, t] += 1.0
            h2, h1 = h1, t
    counts += add_k
    keep = np.ones(V, bool)
    for e in exclude:
        if 0 <= e < V:
            keep[e] = False
    counts[:, :, ~keep] = 1e-20
    logp = np.log(counts) - np.log(counts.sum(axis=2, keepdims=True))
    return logp.astype(np.float32)


def sequence_logprob(logp: np.ndarray, seq) -> float:
    """Host-side log P_lm(seq) for a bigram [V+1, V] or trigram
    [V+1, V+1, V] table (tests / model selection scoring)."""
    V = logp.shape[-1]
    total = 0.0
    if logp.ndim == 2:
        prev = V
        for tok in seq:
            total += float(logp[prev, int(tok)])
            prev = int(tok)
    else:
        h2, h1 = V, V
        for tok in seq:
            total += float(logp[h2, h1, int(tok)])
            h2, h1 = h1, int(tok)
    return total


def build_unigram(
    sequences, vocab_size: int, add_k: float = 0.5,
    exclude: tuple[int, ...] = (),
) -> np.ndarray:
    """Smoothed unigram distribution of the text corpus -> [V] float32."""
    counts = np.zeros(vocab_size, np.float64)
    for seq in sequences:
        for tok in seq:
            t = int(tok)
            if 0 <= t < vocab_size:
                counts[t] += 1.0
    counts += add_k
    for e in exclude:
        if 0 <= e < vocab_size:
            counts[e] = 1e-20
    return (counts / counts.sum()).astype(np.float32)


def unsup_selection_score(
    hyps, hyp_lens, lm_logp: np.ndarray, unigram: np.ndarray,
    kl_weight: float = 1.0,
    coverage_weight: float = 1.0,
) -> dict:
    """Label-free validation metric (wav2vec-U model selection): mean LM
    token log-prob of the decoded hypotheses MINUS kl_weight * KL(token
    usage || text unigram) MINUS coverage_weight * KL(text bigram joint
    || hypothesis bigram usage). Higher = better.

    Three terms, three failure modes:
      - the LM term punishes emitting n-grams the text lacks, but has a
        degenerate optimum (always emit the single most probable
        string);
      - the unigram usage KL blocks that degeneracy but is blind to any
        ORDER permutation that preserves marginal frequencies;
      - the coverage KL (the EODM distribution-matching direction:
        text-weighted log of the MODEL's n-gram frequencies, as a KL so
        a matched model scores 0) punishes failing to produce the
        bigrams the text HAS — a consistently permuted phone mapping
        misses most true bigrams and is driven sharply negative.

    hyps: [N, T] int array (or list of sequences), hyp_lens: [N].
    `lm_logp` may be a bigram or trigram table (sequence_logprob
    dispatches on rank); the coverage term needs the text bigram joint
    (unigram x conditional). For a trigram table the bigram conditional
    is the table's IMPLIED bigram — P(w | h1) = Σ_h2 unigram(h2) ·
    P(w | h2, h1), marginalizing the unknown second-order history with
    the unigram — so trigram-LM pipelines keep the anti-permutation
    signal.
    Returns {"score", "lm_logprob_per_token", "usage_kl",
    "coverage_kl", "tokens"}.
    """
    V = lm_logp.shape[-1]
    total_lp, total_tok = 0.0, 0
    counts = np.zeros(V, np.float64)
    pair_counts = np.zeros((V, V), np.float64)
    for i in range(len(hyps)):
        seq = [int(c) for c in np.asarray(hyps[i])[: int(hyp_lens[i])]]
        total_lp += sequence_logprob(lm_logp, seq)
        total_tok += len(seq)
        for c in seq:
            counts[c] += 1.0
        for a, b in zip(seq, seq[1:]):
            pair_counts[a, b] += 1.0
    if total_tok == 0:
        # an always-silent model must never win selection
        return {"score": -1e9, "lm_logprob_per_token": -1e9,
                "usage_kl": float("inf"), "coverage_kl": None,
                "tokens": 0}
    mean_lp = total_lp / total_tok
    usage = (counts + 1e-9) / (counts.sum() + 1e-9 * V)
    kl = float(np.sum(
        usage * (np.log(usage) - np.log(np.maximum(unigram, 1e-12)))
    ))
    cov = None
    if coverage_weight != 0.0:
        uni = np.asarray(unigram, np.float64)
        if lm_logp.ndim == 2:
            cond = np.exp(np.asarray(lm_logp[:V], np.float64))
        else:
            # implied bigram conditional of the trigram table:
            # P(w | h1) = Σ_h2 unigram(h2) P(w | h2, h1)
            P3 = np.exp(np.asarray(lm_logp[:V, :V], np.float64))
            cond = np.einsum("h,hij->ij", uni, P3)
            cond = cond / np.maximum(cond.sum(-1, keepdims=True), 1e-12)
        # text bigram joint p(h, w) = unigram[h] * P(w | h)
        p = uni[:, None] * cond
        p = p / max(p.sum(), 1e-12)
        # add-k smoothed hypothesis bigram usage (same k as the LM
        # build: the absolute penalty for a missing text bigram is
        # bounded and comparable across candidates on one dev set)
        q = (pair_counts + 0.5) / (pair_counts.sum() + 0.5 * V * V)
        cov = float(np.sum(
            p * (np.log(np.maximum(p, 1e-12)) - np.log(q))
        ))
    return {
        "score": float(
            mean_lp - kl_weight * kl
            - (coverage_weight * cov if cov is not None else 0.0)
        ),
        "lm_logprob_per_token": float(mean_lp),
        "usage_kl": kl,
        "coverage_kl": cov,
        "tokens": int(total_tok),
    }
