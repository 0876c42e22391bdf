"""Frame-level cross-entropy on forced alignments (counterpart of
``uasr.ops.frame_ce``).

When per-frame phone labels exist (a forced alignment, or a teacher's
aligned pseudo-labels), the acoustic model trains with plain masked CE
instead of the CTC lattice. The JAX package computes this outside any
Pallas kernel (optax's ``softmax_cross_entropy_with_integer_labels``);
here it is ``F.cross_entropy`` on the f32 logits, on their device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from uasr_torch.parallel.collectives import batch_sum


def _valid(logits: torch.Tensor, logit_lengths: torch.Tensor, frame_labels: torch.Tensor,
           label_pad: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(labels truncated to the logits' T, mask of the frames that count:
    inside the utterance and labelled)."""
    T = logits.shape[1]
    labels = frame_labels[:, :T].to(logits.device).long()
    t = torch.arange(T, device=logits.device)
    valid = (t[None, :] < logit_lengths.to(logits.device)[:, None]) & (labels != label_pad)
    return labels, valid


def frame_ce_loss(logits: torch.Tensor, logit_lengths: torch.Tensor, frame_labels: torch.Tensor,
                  label_pad: int = -1) -> torch.Tensor:
    """Masked mean CE. logits [B, T, V]; frame_labels [B, >= T] with
    ``label_pad`` marking frames without a label (padding or a downsample
    mismatch). Over a mesh both sums are the global batch's."""
    labels, valid = _valid(logits, logit_lengths, frame_labels, label_pad)
    B, T, V = logits.shape
    ce = F.cross_entropy(logits.float().reshape(B * T, V), labels.clamp_min(0).reshape(-1),
                         reduction="none").reshape(B, T)
    return batch_sum(torch.where(valid, ce, 0.0).sum()) / batch_sum(valid.sum()).clamp_min(1)


def frame_accuracy(logits: torch.Tensor, logit_lengths: torch.Tensor, frame_labels: torch.Tensor,
                   label_pad: int = -1) -> torch.Tensor:
    """Share of the labelled frames whose argmax is the label."""
    labels, valid = _valid(logits, logit_lengths, frame_labels, label_pad)
    hit = valid & (torch.argmax(logits, dim=-1) == labels)
    return batch_sum(hit.sum().float()) / batch_sum(valid.sum()).clamp_min(1)
