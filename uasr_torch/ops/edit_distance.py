"""Batched Levenshtein distance on the tensors' device (counterpart of
``uasr.ops.edit_distance``).

The row recurrence's insertion chain is a prefix minimum:
    dp_new[j] = min_{k <= j} (base[k] + (j - k)) = j + cummin(base[k] - k),
so each hypothesis token costs one O(N) vector step for the whole batch.
"""

from __future__ import annotations

import torch

BIG = 1 << 20


def batch_edit_distance(
    refs: torch.Tensor,
    ref_lengths: torch.Tensor,
    hyps: torch.Tensor,
    hyp_lengths: torch.Tensor,
) -> torch.Tensor:
    """Levenshtein distance per pair. refs: [B, N], hyps: [B, M] int."""
    B, N = refs.shape
    dev = refs.device
    j = torch.arange(N + 1, device=dev)[None, :]
    in_ref = j <= ref_lengths[:, None]
    dp = torch.where(in_ref, j, BIG)
    # rows past every hypothesis' length leave dp unchanged
    M = min(hyps.shape[1], int(hyp_lengths.max()) if hyp_lengths.numel() else 0)
    for i in range(1, M + 1):
        sub_cost = (refs != hyps[:, i - 1 : i]).long()
        diag = dp[:, :-1] + sub_cost  # dp_old[j-1] + cost, j = 1..N
        up = dp[:, 1:] + 1  # dp_old[j] + 1
        base = torch.cat([torch.full((B, 1), i, dtype=dp.dtype, device=dev),
                          torch.minimum(diag, up)], dim=1)
        new = torch.cummin(base - j, dim=1).values + j
        new = torch.where(in_ref, new, BIG)
        dp = torch.where((i <= hyp_lengths)[:, None], new, dp)
    return dp.gather(1, ref_lengths[:, None].long())[:, 0]
