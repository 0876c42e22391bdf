"""InfoNCE contrastive loss for self-supervised pretraining (counterpart
of ``uasr.ops.infonce``): CPC / wav2vec-style, over cosine similarities.

Plain PyTorch on the inputs' device, as the JAX package computes it in
XLA outside any Pallas kernel. The summation structure is JAX's: the
positive scores are K shifted slices of the normalised latents, the
division by the prediction norm is applied to the scores (no normalised
copy of the predictions), negatives are every valid in-utterance
position (exact softmax) or N sampled positions, and a sampled negative
that is the target itself is masked out. Products of the compute dtype
accumulate in f32 (``preferred_element_type``): operands are cast to f32
first, whose products of bf16 values are exact. Under a mesh the loss and
the accuracy are the global batch's (``batch_sum`` of their sums and
counts) and the negatives are drawn for the global batch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from uasr_torch.parallel.collectives import batch_sum, global_rows, local_rows

_NEG_INF = -1e30


def _l2norm(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """x / |x| along the last axis; the norm in f32, the result in x's dtype."""
    inv = torch.rsqrt(torch.sum(torch.square(x.float()), -1, keepdim=True) + eps)
    return x * inv.to(x.dtype)


def _pos_scores(preds: torch.Tensor, zpad: torch.Tensor, T: int) -> torch.Tensor:
    """[B, T, K] dot of prediction (t, k) with zpad[:, t + k + 1], one shifted
    slice per k; f32."""
    K = preds.shape[2]
    return torch.stack([torch.einsum("btc,btc->bt", preds[:, :, k].float(),
                                     zpad[:, k + 1: k + 1 + T].float())
                        for k in range(K)], -1)


def _sampled_terms(preds, pos, inv_pn, zneg, neg_indices, targets, temperature):
    """(nll, win) [B, T, K] over {pos} and the sampled negatives."""
    neg = torch.einsum("btkc,bnc->btkn", preds.float(), zneg.float()) \
        * inv_pn[..., None] / temperature
    # a negative that is the target would compete with the positive
    collide = neg_indices[:, None, None, :] == targets[..., None]
    neg = torch.where(collide, _NEG_INF, neg)
    lse = torch.logaddexp(torch.logsumexp(neg, -1), pos)
    return lse - pos, pos >= neg.amax(-1)


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, T, C] at positions idx [B, N] -> [B, N, C]."""
    return torch.gather(x, 1, idx[..., None].expand(*idx.shape, x.shape[-1]))


def info_nce_loss(preds: torch.Tensor, z: torch.Tensor, lengths: torch.Tensor,
                  temperature: float = 0.1, neg_indices: torch.Tensor | None = None):
    """(mean NLL over valid (t, k) pairs, accuracy: the share of pairs whose
    positive wins). ``preds`` [B, T, K, C] predicts z[:, t + k + 1] from
    step t; ``z`` [B, T, C]; negatives are every valid position
    (``neg_indices`` None) or ``neg_indices`` [B, N]."""
    B, T, K, C = preds.shape
    dev = preds.device
    inv_pn = torch.rsqrt(torch.sum(torch.square(preds.float()), -1) + 1e-8)  # [B, T, K]
    zn = _l2norm(z)
    targets = torch.arange(T, device=dev)[None, :, None] \
        + torch.arange(1, K + 1, device=dev)[None, None, :]  # [1, T, K]
    pair_valid = targets < lengths[:, None, None]
    pos = _pos_scores(preds, F.pad(zn, (0, 0, 0, K)), T) * inv_pn / temperature
    if neg_indices is None:
        scores = torch.einsum("btkc,bsc->btks", preds.float(), zn.float()) \
            * inv_pn[..., None] / temperature
        valid_s = torch.arange(T, device=dev)[None, :] < lengths[:, None]
        scores = torch.where(valid_s[:, None, None, :], scores, _NEG_INF)
        nll = torch.logsumexp(scores, -1) - pos
        # the target column is the einsum's own copy of pos: accuracy
        # compares pos against the true negatives only
        is_tgt = torch.arange(T, device=dev)[None, None, None, :] == targets[..., None]
        win = pos >= torch.where(is_tgt, _NEG_INF, scores).amax(-1)
    else:
        nll, win = _sampled_terms(preds, pos, inv_pn, _gather_rows(zn, neg_indices),
                                  neg_indices, targets, temperature)
    denom = torch.clamp(batch_sum(pair_valid.sum()), min=1)
    loss = batch_sum(torch.sum(torch.where(pair_valid, nll, 0.0))) / denom
    acc = batch_sum((pair_valid & win).sum()) / denom
    return loss, acc


def info_nce_loss_fused(c: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                        z: torch.Tensor, lengths: torch.Tensor, num_steps: int,
                        temperature: float = 0.1, neg_indices: torch.Tensor | None = None,
                        chunk: int = 128):
    """``info_nce_loss(heads(c), ...)`` with sampled negatives, the heads
    folded in: a loop over time chunks of ``chunk`` frames, each computing
    its [B, chunk, K, C] predictions from ``c`` [B, T, Ch] with the heads'
    ``weight`` [K * C, Ch] and ``bias`` [K * C] (the port's Dense layout)
    and recomputing them in the backward (``torch.utils.checkpoint``), as
    JAX's ``lax.scan`` over ``jax.checkpoint``ed chunks does. The heads run
    in ``c``'s dtype, as JAX casts them to it."""
    if neg_indices is None:
        raise ValueError(
            "info_nce_loss_fused needs sampled negatives (ssl.num_negatives > 0); the "
            "exact-softmax path is the small-T/test configuration — use info_nce_loss")
    B, T, Ch = c.shape
    K, C = num_steps, z.shape[-1]
    dev = c.device
    weight, bias = weight.to(c.dtype), bias.to(c.dtype)
    zn = _l2norm(z)
    zpad = F.pad(zn, (0, 0, 0, K + chunk))
    zneg = _gather_rows(zn, neg_indices)
    n_chunks = -(-T // chunk)
    cpad = F.pad(c, (0, 0, 0, n_chunks * chunk - T))
    steps = torch.arange(1, K + 1, device=dev)[None, None, :]

    def body(c_chunk, t0: int):
        preds = (torch.matmul(c_chunk.float(), weight.float().T).to(c_chunk.dtype)
                 + bias).reshape(B, chunk, K, C)
        inv_pn = torch.rsqrt(torch.sum(torch.square(preds.float()), -1) + 1e-8)
        pos = _pos_scores(preds, zpad[:, t0: t0 + chunk + K], chunk) * inv_pn / temperature
        targets = (t0 + torch.arange(chunk, device=dev))[None, :, None] + steps
        pair_valid = targets < lengths[:, None, None]
        nll, win = _sampled_terms(preds, pos, inv_pn, zneg, neg_indices, targets, temperature)
        return (torch.sum(torch.where(pair_valid, nll, 0.0)),
                torch.sum(torch.where(pair_valid, win, False).float()), pair_valid.sum())

    nll_sum = win_sum = torch.zeros((), device=dev)
    cnt = torch.zeros((), dtype=torch.long, device=dev)
    for i in range(n_chunks):
        c_chunk = cpad[:, i * chunk: (i + 1) * chunk]
        if torch.is_grad_enabled():
            terms = checkpoint(body, c_chunk, i * chunk, use_reentrant=False)
        else:
            terms = body(c_chunk, i * chunk)
        nll_sum, win_sum, cnt = nll_sum + terms[0], win_sum + terms[1], cnt + terms[2]
    denom = torch.clamp(batch_sum(cnt), min=1)
    return batch_sum(nll_sum) / denom, batch_sum(win_sum) / denom


def sample_negatives(generator: torch.Generator, lengths: torch.Tensor,
                     num: int) -> torch.Tensor:
    """[B, N] uniform positions in [0, length_b) per utterance, drawn on the
    CPU from ``generator`` and placed on ``lengths``' device; an empty
    utterance gives position 0."""
    u = local_rows(torch.rand((global_rows(lengths.shape[0]), num),
                              generator=generator)).to(lengths.device)
    return torch.minimum((u * torch.clamp(lengths, min=1)[:, None]).long(),
                         torch.clamp(lengths[:, None] - 1, min=0))
