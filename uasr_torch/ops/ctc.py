"""CTC loss as a log-semiring forward recursion (counterpart of
``uasr.ops.ctc``, the ``ctc.use_pallas: false`` path).

The extended label sequence (blank-interleaved, length S = 2U+1) is
static-shaped per batch; one loop step per frame updates all S alpha
states of all B utterances at once; variable logit lengths carry alpha
unchanged past each utterance's last frame. The gradient comes from
autograd through the loop (logsumexp's backward is the posterior).
Everything stays finite: log-zero is ``LOG_EPSILON`` (-1e5), never
``-inf``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

LOG_EPSILON = -1e5  # finite "-inf" (matches optax) so grads stay NaN-free


def _logsumexp3(a, b, c):
    m = torch.maximum(torch.maximum(a, b), c)
    m = torch.clamp(m, min=LOG_EPSILON)  # avoid -inf - -inf
    return m + torch.log(torch.exp(a - m) + torch.exp(b - m) + torch.exp(c - m))


def extended_labels(labels: torch.Tensor, blank_id: int) -> torch.Tensor:
    """[B, U] labels -> [B, 2U+1] blank-interleaved sequence z (int64)."""
    B, U = labels.shape
    z = torch.full((B, 2 * U + 1), blank_id, dtype=torch.long, device=labels.device)
    z[:, 1::2] = labels.long()
    return z


def skip_allowed(z: torch.Tensor, blank_id: int) -> torch.Tensor:
    """Transition from s-2 allowed where z[s] != blank and z[s] != z[s-2]."""
    z_shift2 = F.pad(z, (2, 0), value=blank_id)[:, : z.shape[1]]
    return (z != blank_id) & (z != z_shift2)


def ctc_loss(logits, logit_lengths, labels, label_lengths, blank_id: int = 0) -> torch.Tensor:
    """Per-utterance negative log likelihood, shape [B].

    logits: [B, T, V] unnormalised; labels: [B, U] (values != blank_id on
    the first ``label_lengths`` positions).
    """
    B, T, V = logits.shape
    S = 2 * labels.shape[1] + 1
    dev = logits.device
    logp = torch.log_softmax(logits, dim=-1)
    z = extended_labels(labels, blank_id)
    skip_ok = skip_allowed(z, blank_id)
    s_idx = torch.arange(S, device=dev)[None, :]
    label_lengths = label_lengths.to(dev)
    logit_lengths = logit_lengths.to(dev)
    s_valid = s_idx < (2 * label_lengths + 1)[:, None]
    neg = torch.full((B, S), LOG_EPSILON, dtype=logp.dtype, device=dev)
    emit = torch.gather(logp, 2, z[:, None, :].expand(B, T, S)).transpose(0, 1)  # [T, B, S]

    alpha = torch.cat([emit[0, :, :1],
                       torch.where(label_lengths[:, None] > 0, emit[0, :, 1:2], LOG_EPSILON),
                       neg[:, 2:]], dim=1)
    alpha = torch.where(s_valid, alpha, LOG_EPSILON)
    for t in range(1, T):
        a_prev1 = F.pad(alpha, (1, 0), value=LOG_EPSILON)[:, :S]
        a_prev2 = F.pad(alpha, (2, 0), value=LOG_EPSILON)[:, :S]
        a_prev2 = torch.where(skip_ok, a_prev2, LOG_EPSILON)
        new = _logsumexp3(alpha, a_prev1, a_prev2) + emit[t]
        new = torch.where(s_valid, new, LOG_EPSILON)
        # carry alpha unchanged for finished utterances
        alpha = torch.where((t < logit_lengths)[:, None], new, alpha)

    # final states: S_b - 1 (last blank) and S_b - 2 (last label)
    last = 2 * label_lengths
    a_last = torch.gather(alpha, 1, last[:, None])[:, 0]
    a_prev = torch.gather(alpha, 1, torch.clamp(last - 1, min=0)[:, None])[:, 0]
    a_prev = torch.where(label_lengths > 0, a_prev, LOG_EPSILON)
    m = torch.clamp(torch.maximum(a_last, a_prev), min=LOG_EPSILON)
    ll = m + torch.log(torch.exp(a_last - m) + torch.exp(a_prev - m))
    return -ll


def ctc_loss_mean(logits, logit_lengths, labels, label_lengths, blank_id: int = 0):
    """Batch-mean CTC loss over the B rows."""
    return ctc_loss(logits, logit_lengths, labels, label_lengths, blank_id).mean()
