"""Token n-gram language model tables (counterpart of ``uasr.ops.lm``):
the add-k builds of ``prepare lm``, ARPA import (``prepare import-arpa``:
the Katz backoff chain evaluated into every cell), the tables' files, and
the label-free selection score.

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


def load_decode_table(path: str, V: int, mismatch) -> np.ndarray:
    """``load_lm`` for a decoder over V tokens: a table that is neither a
    [V + 1, V] bigram nor a [V + 1, V + 1, V] trigram raises ValueError
    with ``mismatch(shape)`` as its text (a mismatched table would index
    past its rows)."""
    table = load_lm(path)
    if table.shape not in ((V + 1, V), (V + 1, V + 1, V)):
        raise ValueError(mismatch(table.shape))
    return table


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


def parse_arpa(path: str) -> dict:
    """Parse an ARPA-format n-gram LM file (the KenLM/SRILM interchange
    format the wav2vec-U lineage ships its phoneme LMs in).

    Returns {order: {(sym, ...): (log10_prob, log10_backoff)}} — backoff
    is 0.0 when the entry carries none. Accepts the standard layout:
    \\data\\ counts, \\N-grams: sections with tab- or space-separated
    fields, \\end\\."""
    ngrams: dict[int, dict] = {}
    order = 0
    with open(path) as f:
        for raw in f:
            line = raw.strip()
            if not line or line.startswith("\\data\\"):
                continue
            if line.startswith("\\end\\"):
                break
            if line.startswith("\\") and line.endswith("-grams:"):
                order = int(line[1:].split("-")[0])
                ngrams[order] = {}
                continue
            if order == 0:  # still in the \data\ header ("ngram 1=N")
                continue
            parts = line.split()
            if len(parts) < order + 1:
                continue
            lp = float(parts[0])
            syms = tuple(parts[1 : 1 + order])
            bo = (
                float(parts[order + 1])
                if len(parts) > order + 1 else 0.0
            )
            ngrams[order][syms] = (lp, bo)
    if not ngrams:
        raise ValueError(f"{path}: no n-gram sections found (not ARPA?)")
    return ngrams


def arpa_to_table(
    ngrams: dict,
    tokens: list[str],
    order: int | None = None,
    exclude: tuple[int, ...] = (),
) -> tuple[np.ndarray, np.ndarray]:
    """Evaluate an ARPA model's backoff chain into the dense decode
    table (`ctc.lm_path` format): [V+1, V] for order 2 or
    [V+1, V+1, V] for order 3, history index V = start-of-sequence
    (the ARPA '<s>' context). Returns (logp_table, unigram).

    Backoff semantics (Katz): P(w|h) = 10^lp(h,w) if the n-gram is
    listed, else 10^bo(h) * P(w|h') with h' the shortened history; an
    unlisted history backs off with weight 1. Rows are renormalized
    over the DECODER's column space (real tokens; `exclude` columns —
    the CTC blank — and ARPA-only symbols like </s>/<unk> drop out),
    so table rows are proper distributions for shallow fusion.
    Vocabulary tokens absent from the ARPA get the <unk> unigram when
    present, else a floor — every transition stays finite/decodable."""
    V = len(tokens)
    if order is None:
        order = min(max(ngrams), 3)
    if order not in (2, 3):
        raise ValueError(f"dense decode tables support order 2 or 3, "
                         f"got {order}")
    if order > max(ngrams):
        raise ValueError(
            f"requested order {order} but the ARPA file only has "
            f"{max(ngrams)}-grams"
        )
    uni = ngrams.get(1, {})
    unk_lp = uni.get(("<unk>",), (None, 0.0))[0]
    tok2id = {t: i for i, t in enumerate(tokens)}
    tok2id["<s>"] = V

    # column probabilities + per-history backoff weights, by symbol
    p1 = np.full((V,), 1e-12, np.float64)
    for i, t in enumerate(tokens):
        lp = uni.get((t,), (None, 0.0))[0]
        if lp is None:
            lp = unk_lp
        if lp is not None:
            p1[i] = 10.0 ** lp
    # history axis: 0..V-1 = real tokens, V = '<s>'
    hist = tokens + ["<s>"]
    bo1 = np.ones((V + 1,), np.float64)
    for h, sym in enumerate(hist):
        ent = uni.get((sym,))
        if ent is not None:
            bo1[h] = 10.0 ** ent[1]

    P2 = bo1[:, None] * p1[None, :]
    for (s1, s2), (lp, _bo) in ngrams.get(2, {}).items():
        h, w = tok2id.get(s1), tok2id.get(s2)
        if h is None or w is None or w == V:
            continue  # symbol outside the decoder vocabulary
        P2[h, w] = 10.0 ** lp

    keep = np.ones(V, bool)
    for e in exclude:
        if 0 <= e < V:
            keep[e] = False

    def norm(P):
        P = P.copy()
        P[..., ~keep] = 1e-20
        return (np.log(P) - np.log(P.sum(-1, keepdims=True))).astype(
            np.float32
        )

    unigram = (p1 * keep) / max((p1 * keep).sum(), 1e-12)
    if order == 2:
        return norm(P2), unigram.astype(np.float32)

    bo2 = np.ones((V + 1, V + 1), np.float64)
    for (s1, s2), (_lp, bo) in ngrams.get(2, {}).items():
        h2, h1 = tok2id.get(s1), tok2id.get(s2)
        if h2 is None or h1 is None:
            continue
        bo2[h2, h1] = 10.0 ** bo
    # histories containing '<s>' in slot h1 never re-enter P2's start
    # row except via the (V, V) = sentence-start context, which P2
    # row V already is
    P3 = bo2[:, :, None] * P2[None, :, :]
    for (s1, s2, s3), (lp, _bo) in ngrams.get(3, {}).items():
        h2, h1, w = tok2id.get(s1), tok2id.get(s2), tok2id.get(s3)
        if h2 is None or h1 is None or w is None or w == V:
            continue
        P3[h2, h1, w] = 10.0 ** lp
    return norm(P3), unigram.astype(np.float32)


def load_arpa(
    path: str,
    tokens: list[str],
    order: int | None = None,
    exclude: tuple[int, ...] = (),
) -> tuple[np.ndarray, np.ndarray]:
    """ARPA file -> (dense decode table, unigram). See arpa_to_table."""
    return arpa_to_table(parse_arpa(path), tokens, order, exclude)


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
