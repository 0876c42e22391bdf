"""Bucketed batches: the training feed and the batch-transcription requests.

Parameters: ``batch`` utterances a batch, ``buckets`` (the recipe's
boundaries in seconds; a batch is padded to its bucket's boundary),
``lengths`` (the cut normal of ``common``), ``batches`` in the pool,
``chars_per_s`` and ``max_label`` for the labels (ids uniform in
``label_ids`` [lo, hi)), ``amplitude``.

Each bucket gets a share of the pool's batches in proportion to its share
of the lengths; a bucket's utterances are the quantiles of the distribution
inside it. The seed shuffles utterances between a bucket's batches, orders
the batches (the buckets' sequence is spread evenly and is the same for
every seed) and draws the audio and the labels. Returns a list of
``(audio [B, L] float32, audio_lengths [B] int32, labels [B, max_label]
int32, label_lengths [B] int32)``.
"""

from __future__ import annotations

import numpy as np

from benchmark.traffic.common import interleave, noise_bank, quantiles, shares, split


def generate(p: dict, seed: int, sample_rate: int = 16000) -> list[tuple]:
    rng = np.random.default_rng(seed)
    B, edges = p["batch"], list(p["buckets"])
    counts = split(p["batches"], shares(p["lengths"], edges))
    bank = noise_bank(rng, p["amplitude"])
    lo_id, hi_id = p["label_ids"]
    by_bucket = []
    for k, n in enumerate(counts):
        lo = edges[k - 1] if k else None
        secs = quantiles(p["lengths"], n * B, -np.inf if lo is None else lo, edges[k])
        secs = rng.permutation(secs).reshape(n, B) if n else np.zeros((0, B))
        by_bucket.append(list(secs))
    seq = interleave(counts)
    order = [list(rng.permutation(int(n))) for n in counts]
    pool = []
    for k in seq:
        secs = by_bucket[k][order[k].pop()]
        L = int(round(edges[k] * sample_rate))
        lens = np.minimum((secs * sample_rate).astype(np.int64), L).astype(np.int32)
        audio = np.zeros((B, L), np.float32)
        offs = rng.integers(0, len(bank) - L, B)
        for i in range(B):
            audio[i, : lens[i]] = bank[offs[i]: offs[i] + lens[i]]
        ulen = np.minimum((secs * p["chars_per_s"]).astype(np.int32), p["max_label"])
        labels = rng.integers(lo_id, hi_id, (B, p["max_label"]), dtype=np.int32)
        labels[np.arange(p["max_label"])[None, :] >= ulen[:, None]] = 0
        pool.append((audio, lens, labels, ulen.astype(np.int32)))
    return pool
