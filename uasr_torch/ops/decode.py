"""CTC decoding on the logits' device (counterpart of ``uasr.ops.decode``):
greedy and exact prefix beam search.

``ctc_beam_search_decode`` has the semantics of the JAX package's
``ctc_beam_search_decode(merge_impl="fold")`` with no per-beam pruning
(prune >= V): the recursion is kernel K4 on CUDA tensors and its plain
version on CPU tensors (``uasr_torch.ops.cuda_beam``); the winning
prefix is rebuilt from per-step (parent, char) backpointers.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from uasr_torch.ops.cuda_beam import beam_traceback, compact_left, ctc_beam_steps


def ctc_greedy_decode(
    logits: torch.Tensor, lengths: torch.Tensor, blank_id: int = 0
) -> tuple[torch.Tensor, torch.Tensor]:
    """Argmax -> collapse repeats -> drop blanks.

    Returns (ids [B, T] left-compacted and padded with blank_id,
    out_lengths [B])."""
    B, T, V = logits.shape
    ids = logits.argmax(-1)
    valid = torch.arange(T, device=logits.device)[None, :] < lengths[:, None]
    ids = torch.where(valid, ids, blank_id)
    prev = F.pad(ids, (1, 0), value=-1)[:, :T]
    keep = (ids != prev) & (ids != blank_id) & valid
    return compact_left(ids, keep, blank_id), keep.sum(1)


def ctc_beam_search_decode(
    logits: torch.Tensor,
    lengths: torch.Tensor,
    beam_width: int = 8,
    blank_id: int = 0,
    lm_logp: torch.Tensor | None = None,
    lm_weight: float = 1.0,
    lm_bonus: float = 0.0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact CTC prefix beam search with optional shallow n-gram LM fusion.

    ``lm_logp`` is a bigram [V + 1, V] or trigram [V + 1, V + 1, V] table
    of token log-probabilities (history index V = start of sequence);
    each prefix extension adds ``lm_weight * logP(c | history) +
    lm_bonus``. Returns (ids [B, T] best prefix padded with blank_id,
    out_lengths [B], log-prob [B] of the best prefix)."""
    B, T, V = logits.shape
    logp = torch.log_softmax(logits.float(), dim=-1).contiguous()
    lm_table, lm_order = None, 0
    if lm_logp is not None:
        if tuple(lm_logp.shape) not in ((V + 1, V), (V + 1, V + 1, V)):
            raise ValueError(
                f"LM table shape {tuple(lm_logp.shape)} does not match V={V} "
                f"([{V + 1}, {V}] bigram or [{V + 1}, {V + 1}, {V}] trigram)"
            )
        lm_order = lm_logp.ndim
        lm_table = lm_logp.to(device=logp.device, dtype=torch.float32).reshape(-1, V).contiguous()
    parents, chars, state = ctc_beam_steps(logp, lengths, beam_width, blank_id, lm_table,
                                           lm_order, lm_weight, lm_bonus)
    return beam_traceback(parents, chars, state.p_b, state.p_nb, blank_id)
