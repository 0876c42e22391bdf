"""EODM: empirical output-distribution matching (counterpart of
``uasr.ops.eodm``; Yeh et al., ICLR 2019).

The loss is the cross-entropy between the top-K n-gram statistics of
unpaired text and the expected n-gram frequencies of the model's
per-frame posteriors,

    p_model(g) = mean over valid t of  prod_i  post[t + i, g_i],
    loss = - sum_g  p_hat(g) * log p_model(g),  summed over orders,

computed by picking the posteriors at each n-gram's symbols. The picks are
products with one-hot selection matrices rather than gathers: the
forward is exact all the same (one 1.0 a column), and the backward is a
product too, so it is deterministic on the card, where a gather's
backward scatter-adds with atomics. The top-K tables are built on the
host once (``build_ngram_table``) and move to the device as [K, n] index
and [K] probability tensors.
"""

from __future__ import annotations

from collections import Counter
from typing import NamedTuple, Sequence

import numpy as np
import torch


class NgramTable(NamedTuple):
    """Top-K n-grams of one order: ids [K, n] int32, probs [K] float32."""

    ids: np.ndarray
    probs: np.ndarray

    @property
    def order(self) -> int:
        return self.ids.shape[1]


def build_ngram_table(sequences: Sequence[Sequence[int]], order: int, top_k: int) -> NgramTable:
    """Count n-grams over id sequences and keep the top-K with renormalised
    probabilities (ties in the order of first occurrence)."""
    counts: Counter = Counter()
    for seq in sequences:
        for i in range(len(seq) - order + 1):
            counts[tuple(seq[i : i + order])] += 1
    top = counts.most_common(top_k)
    if not top:
        raise ValueError(f"no {order}-grams found in text corpus")
    ids = np.asarray([g for g, _ in top], dtype=np.int32)
    c = np.asarray([n for _, n in top], dtype=np.float64)
    probs = (c / c.sum()).astype(np.float32)
    return NgramTable(ids=ids, probs=probs)


def save_ngram_tables(path: str, tables: Sequence[NgramTable]) -> None:
    """The npz ``load_ngram_tables`` reads (ids_{n} / probs_{n} per order)."""
    payload = {}
    for t in tables:
        payload[f"ids_{t.order}"] = t.ids
        payload[f"probs_{t.order}"] = t.probs
    np.savez(path, **payload)


def load_ngram_tables(path: str, orders: Sequence[int]) -> list[NgramTable]:
    """Load tables written by ``python -m uasr_torch.tools.prepare ngrams``."""
    z = np.load(path)
    tables = []
    for n in orders:
        if f"ids_{n}" not in z:
            raise ValueError(f"{path} has no order-{n} table (keys: {list(z)})")
        tables.append(NgramTable(ids=z[f"ids_{n}"], probs=z[f"probs_{n}"]))
    return tables


def device_ngram_tables(ecfg, text_sequences, device="cpu") -> list[tuple[torch.Tensor,
                                                                          torch.Tensor]]:
    """Tables as tensors on ``device``: from ``ecfg.ngram_path`` if set, else
    built from the unpaired text corpus."""
    if ecfg.ngram_path:
        tables = load_ngram_tables(ecfg.ngram_path, ecfg.ngram_orders)
    else:
        tables = [build_ngram_table(text_sequences, n, ecfg.top_k) for n in ecfg.ngram_orders]
    return [(torch.as_tensor(t.ids, dtype=torch.long, device=device),
             torch.as_tensor(t.probs, dtype=torch.float32, device=device)) for t in tables]


def expected_ngram_logprobs(probs: torch.Tensor, lengths: torch.Tensor,
                            ngram_ids: torch.Tensor, log_floor: float = 1e-10,
                            k_chunk: int = 0) -> torch.Tensor:
    """log of the batch-expected frequency of each table entry.

    probs [B, T, V] frame posteriors, ngram_ids [K, n] -> [K] log p_model.
    ``k_chunk > 0`` bounds the peak to [B, Tp, k_chunk] by walking the
    table in chunks."""
    B, T, V = probs.shape
    K, n = ngram_ids.shape
    Tp = T - n + 1
    # positions with a full n-gram inside the valid region
    pos_valid = (torch.arange(Tp, device=probs.device)[None, :]
                 < torch.clamp(lengths - n + 1, min=0)[:, None]).to(probs.dtype)  # [B, Tp]
    denom = torch.clamp(pos_valid.sum(), min=1)

    def chunk_totals(ids: torch.Tensor) -> torch.Tensor:
        # ids [C, n] -> [C] batch totals of the n-gram product
        prod = torch.ones((B, Tp, ids.shape[0]), dtype=probs.dtype, device=probs.device)
        for i in range(n):
            # posteriors of symbol g_i at offset i: [B, Tp, C]
            pick = torch.nn.functional.one_hot(ids[:, i], V).to(probs.dtype).T  # [V, C]
            prod = prod * (probs[:, i : i + Tp, :] @ pick)
        return torch.sum(prod * pos_valid[..., None], dim=(0, 1))

    if k_chunk <= 0 or K <= k_chunk:
        total = chunk_totals(ngram_ids)
    else:
        total = torch.cat([chunk_totals(ngram_ids[s : s + k_chunk])
                           for s in range(0, K, k_chunk)])
    return torch.log(torch.clamp(total / denom, min=log_floor))


def eodm_loss(logits: torch.Tensor, lengths: torch.Tensor,
              tables: Sequence[tuple[torch.Tensor, torch.Tensor]],
              k_chunk: int = 0) -> torch.Tensor:
    """Cross-entropy of the text's n-gram statistics under the model's
    expected output distribution, summed over orders. ``tables``: per
    order, (ngram ids [K, n], probabilities [K])."""
    probs = torch.softmax(logits, -1)
    loss = 0.0
    for ids, p_hat in tables:
        logp_model = expected_ngram_logprobs(probs, lengths, ids, k_chunk=k_chunk)
        loss = loss - torch.sum(p_hat * logp_model)
    return loss
