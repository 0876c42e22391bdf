"""CTC negative log-likelihood by the forward recursion in log space.

Blank-interleaved labels of length S = 2U + 1; alpha over frames; a frame
past an utterance's length leaves alpha as it is; the likelihood is the
sum of the last two states (the last one alone for an empty label). The
gradient is autograd's through the loop. Log-zero is a large finite
negative, so every gradient stays finite.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

NEG = -1e30


def ctc_nll(logp: torch.Tensor, lengths: torch.Tensor, labels: torch.Tensor,
            label_lengths: torch.Tensor, blank: int = 0) -> torch.Tensor:
    """logp [B, T, V] log-probabilities; labels [B, U] -> NLL [B]."""
    B, T, V = logp.shape
    U = labels.shape[1]
    S = 2 * U + 1
    dev = logp.device
    z = torch.full((B, S), blank, dtype=torch.long, device=dev)
    z[:, 1::2] = labels.long()
    z2 = F.pad(z, (2, 0), value=blank)[:, :S]
    skip = (z != blank) & (z != z2)
    emit = torch.gather(logp, 2, z[:, None, :].expand(B, T, S))  # [B, T, S]
    neg = torch.full((B, S), NEG, device=dev, dtype=logp.dtype)
    alpha = torch.where(torch.arange(S, device=dev)[None, :] < 2, emit[:, 0], neg)
    alpha = torch.where((torch.arange(S, device=dev)[None, :] == 1) & (label_lengths[:, None] == 0),
                        neg, alpha)
    for t in range(1, T):
        a1 = F.pad(alpha, (1, 0), value=NEG)[:, :S]
        a2 = torch.where(skip, F.pad(alpha, (2, 0), value=NEG)[:, :S], neg)
        new = torch.logsumexp(torch.stack([alpha, a1, a2]), 0) + emit[:, t]
        alpha = torch.where((t < lengths)[:, None], new, alpha)
    last = (2 * label_lengths).long()
    a_last = alpha.gather(1, last[:, None])[:, 0]
    a_prev = alpha.gather(1, (last - 1).clamp(min=0)[:, None])[:, 0]
    a_prev = torch.where(label_lengths > 0, a_prev, torch.full_like(a_prev, NEG))
    return -torch.logaddexp(a_last, a_prev)


def loglik(logp: torch.Tensor, lengths: torch.Tensor, seqs: list[list[int]],
           blank: int = 0) -> torch.Tensor:
    """Log-likelihood [B] of each token sequence under its row's log-probs."""
    U = max(max((len(s) for s in seqs), default=0), 1)
    labels = torch.zeros(len(seqs), U, dtype=torch.long, device=logp.device)
    for i, s in enumerate(seqs):
        if s:
            labels[i, :len(s)] = torch.tensor(s, device=logp.device)
    ul = torch.tensor([len(s) for s in seqs], device=logp.device)
    with torch.no_grad():
        return -ctc_nll(logp, lengths, labels, ul, blank)
