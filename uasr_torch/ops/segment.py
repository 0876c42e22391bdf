"""Segmental preprocessing for wav2vec-U-style adversarial training
(counterpart of ``uasr.ops.segment``).

Phone-like segments: quantise frame features with k-means, cut a
boundary wherever the cluster id changes, and mean-pool the features of
each segment, so the generator sees phone-rate inputs.

- ``kmeans_fit``: Lloyd iterations on the host (numpy, a one-time prep
  pass);
- ``quantize``: nearest-centroid ids (one product);
- ``mode_filter`` / ``smooth_ids``: de-flicker the ids;
- ``segment_pool``: mean pooling over cluster-change segments, the
  boundary structure as a one-hot [T, S] product;
- ``merge_repeats_drop_blank``: the CTC-style collapse of a posterior
  stream the GAN and EODM objectives see (boundaries from the argmax, not
  differentiated; the pooled probabilities are).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _sq_dists(feats: np.ndarray, centroids: np.ndarray, rows: int = 16) -> np.ndarray:
    """[N, k] squared distances, ``rows`` points at a time: the [rows, k, D]
    differences stay in cache, where all N at once (N * k * D elements) run
    to gigabytes at wav2vec-U widths. Each row's sum is the same
    reduction either way, so the values equal the one-shot expression's."""
    return np.concatenate([((feats[i: i + rows, None, :] - centroids[None, :, :]) ** 2).sum(-1)
                           for i in range(0, len(feats), rows)])


def kmeans_fit(feats: np.ndarray, k: int, iters: int = 25, seed: int = 0) -> np.ndarray:
    """Lloyd's algorithm on the host (the JAX package's, its distances taken
    in row blocks). feats [N, D] -> centroids [k, D]."""
    rng = np.random.RandomState(seed)
    n = len(feats)
    centroids = feats[rng.choice(n, size=k, replace=n < k)].copy()
    for _ in range(iters):
        d = _sq_dists(feats, centroids)
        assign = d.argmin(1)
        for j in range(k):
            sel = feats[assign == j]
            if len(sel):
                centroids[j] = sel.mean(0)
            else:  # dead centroid: re-seed at the farthest point
                centroids[j] = feats[d.min(1).argmax()]
    return centroids.astype(np.float32)


def quantize(feats: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Nearest-centroid ids. feats [B, T, D], centroids [K, D] -> [B, T]."""
    # ||x - c||^2 = ||x||^2 - 2 x.c + ||c||^2; only the last two matter
    xc = torch.einsum("btd,kd->btk", feats, centroids)
    c2 = torch.sum(centroids ** 2, -1)
    return torch.argmin(c2[None, None, :] - 2.0 * xc, -1)


def _one_hot(idx: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    """jax.nn.one_hot: indices outside [0, n) give an all-zero row."""
    ok = (idx >= 0) & (idx < n)
    oh = F.one_hot(torch.where(ok, idx, 0), n).to(dtype)
    return oh * ok[..., None].to(dtype)


def mode_filter(ids: torch.Tensor, num_clusters: int, radius: int,
                lengths: torch.Tensor | None = None) -> torch.Tensor:
    """Windowed majority vote over cluster ids (+-radius frames, edge
    padded; ties to the lowest id). With ``lengths``, frames past each
    utterance's end first take its last valid frame's id, so padding
    cannot outvote a short final run."""
    if radius <= 0:
        return ids
    T = ids.shape[1]
    if lengths is not None:
        idx = torch.minimum(torch.arange(T, device=ids.device)[None, :], lengths[:, None] - 1)
        ids = ids.gather(1, idx)
    oh = _one_hot(ids, num_clusters, torch.float32)
    pad = torch.cat([oh[:, :1].expand(-1, radius, -1), oh,
                     oh[:, -1:].expand(-1, radius, -1)], 1)
    s = sum(pad[:, i : i + T] for i in range(2 * radius + 1))
    return torch.argmax(s, -1)


def smooth_ids(ids: torch.Tensor) -> torch.Tensor:
    """Remove single-frame cluster blips: a frame whose two neighbours
    agree with each other but not with it takes their id."""
    prev = torch.cat([ids[:, :1], ids[:, :-1]], 1)
    nxt = torch.cat([ids[:, 1:], ids[:, -1:]], 1)
    blip = (prev == nxt) & (ids != prev)
    return torch.where(blip, prev, ids)


def segment_pool(feats: torch.Tensor, lengths: torch.Tensor, cluster_ids: torch.Tensor,
                 max_segments: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Mean-pool features over runs of equal cluster id.

    feats [B, T, D], lengths [B], cluster_ids [B, T] -> (pooled [B, S, D],
    segment counts [B]) with S = ``max_segments`` (default T). Frames past
    ``lengths`` are ignored; segments past an utterance's count are zero."""
    B, T, D = feats.shape
    S = max_segments or T
    valid = torch.arange(T, device=feats.device)[None, :] < lengths[:, None]
    prev = F.pad(cluster_ids, (1, 0), value=-1)[:, :T]
    new_seg = (cluster_ids != prev) & valid
    seg_idx = torch.cumsum(new_seg.long(), 1) - 1  # -1 before the first
    seg_idx = torch.where(valid, seg_idx, S)  # padding frames drop out
    onehot = _one_hot(seg_idx, S, feats.dtype)  # [B, T, S]
    sums = torch.einsum("bts,btd->bsd", onehot, feats)
    counts = onehot.sum(1)
    pooled = sums / torch.clamp(counts, min=1.0)[..., None]
    return pooled, torch.clamp(new_seg.sum(1), max=S)


def merge_repeats_drop_blank(probs: torch.Tensor, lengths: torch.Tensor, blank_id: int = 0,
                             max_out: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """CTC-style collapse of a posterior stream: mean-pool runs of equal
    argmax and drop blank-argmax runs (wav2vec-U's repeat merge with a
    junk sink). probs [B, S, V] -> (pooled [B, S', V], lengths'). The
    boundaries come from the argmax and are not differentiated; the pooled
    probabilities are."""
    B, S, V = probs.shape
    S_out = max_out or S
    with torch.no_grad():
        ids = probs.argmax(-1)
        valid = torch.arange(S, device=probs.device)[None, :] < lengths[:, None]
        prev = F.pad(ids, (1, 0), value=-1)[:, :S]
        run_start = (ids != prev) & valid
        is_new = run_start & (ids != blank_id)
        keep = (ids != blank_id) & valid
        seg_idx = torch.where(keep, torch.cumsum(is_new.long(), 1) - 1, S_out)
        onehot = _one_hot(seg_idx, S_out, probs.dtype)  # [B, S, S']
        counts = onehot.sum(1)
        new_len = torch.clamp(is_new.sum(1), max=S_out)
    sums = torch.einsum("bts,btv->bsv", onehot, probs)
    pooled = sums / torch.clamp(counts, min=1.0)[..., None]
    return pooled, new_len


def kmeans_segment_frontend(feats: torch.Tensor, lengths: torch.Tensor,
                            centroids: torch.Tensor, max_segments: int | None = None,
                            smooth_passes: int = 2, mode_radius: int = 0,
                            quant_feats: torch.Tensor | None = None):
    """quantize -> de-flicker -> segment -> pool. ``quant_feats`` lets the
    boundaries come from another feature view than the pooled input (the
    raw log-mel under ``gan.segment_on_raw``); ``mode_radius > 0`` takes
    the majority vote instead of the blip smoother."""
    ids = quantize(quant_feats if quant_feats is not None else feats, centroids)
    if mode_radius > 0:
        ids = mode_filter(ids, centroids.shape[0], mode_radius, lengths=lengths)
    else:
        for _ in range(smooth_passes):
            ids = smooth_ids(ids)
    return segment_pool(feats, lengths, ids, max_segments)
