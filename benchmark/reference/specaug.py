"""SpecAugment's bands, drawn again from the trainer's seed.

The recipe draws, per step, from a CPU ``torch.Generator`` seeded with
``train_seed * 1_000_003 + step``: for each frequency mask then each time
mask, B widths uniform in [0, max_width] and B raw integers in [0, 2^31 - 1);
a band starts at raw mod max(limit - width, 1), the limit being the
feature width or the row's frame count. Masked bins become 0.
"""

from __future__ import annotations

import torch

INT32_MAX = 2 ** 31 - 1


def keep_mask(train_seed: int, step: int, B: int, T: int, D: int, lengths: torch.Tensor,
              fe: dict) -> torch.Tensor:
    """[B, T, D] bool on ``lengths``' device, True where the feature is kept."""
    g = torch.Generator().manual_seed(train_seed * 1_000_003 + step)
    dev = lengths.device
    keep = torch.ones(B, T, D, dtype=torch.bool, device=dev)

    def band(max_width, limit, size):
        width = torch.randint(0, max_width + 1, (B,), generator=g).to(dev)
        raw = torch.randint(0, INT32_MAX, (B,), generator=g).to(dev)
        start = raw % (limit.long() - width).clamp(min=1)
        pos = torch.arange(size, device=dev)[None, :]
        return ~((pos >= start[:, None]) & (pos < (start + width)[:, None]))

    for _ in range(fe.get("specaug_freq_masks", 0)):
        keep &= band(fe["specaug_freq_mask"], torch.full((B,), D, device=dev), D)[:, None, :]
    for _ in range(fe.get("specaug_time_masks", 0)):
        keep &= band(fe["specaug_time_mask"], lengths.clamp(min=1), T)[:, :, None]
    return keep
