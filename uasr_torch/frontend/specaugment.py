"""SpecAugment (Park et al. 2019): frequency and time masking (counterpart
of ``uasr.frontend.specaugment``).

Two parts, so that the JAX package and the port can be fed the same band
positions: ``draw_bands`` draws each row's (width, start) from an explicit
``torch.Generator`` on the host (widths uniform in [0, max_width], starts
uniform inside the row's valid region), and ``band_keep`` builds the mask
from them with the JAX package's formula. The draws are B integers per
mask, so they are made on the CPU whatever the features' device, and the
same seed gives the same masks on the CPU and on the card. They are not
``jax.random``'s numbers. Under a mesh each draw is made for the global
batch and cut to the rank's rows.
"""

from __future__ import annotations

import torch

from uasr_torch.config import FrontendConfig
from uasr_torch.parallel.collectives import global_rows, local_rows

_INT32_MAX = 2 ** 31 - 1


def draw_bands(generator: torch.Generator, batch: int, max_width: int,
               limit: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One band per row: width in [0, max_width] and start in
    [0, max(limit - width, 1)), as int64 on ``limit``'s device.

    limit: [B] upper bound of the band start (the valid size along the
    axis)."""
    n = global_rows(batch)
    width = local_rows(torch.randint(0, max_width + 1, (n,), generator=generator))
    raw = local_rows(torch.randint(0, _INT32_MAX, (n,), generator=generator))
    width, raw = width.to(limit.device), raw.to(limit.device)
    max_start = torch.clamp(limit.long() - width, min=1)
    return width, raw % max_start


def band_keep(size: int, width: torch.Tensor, start: torch.Tensor) -> torch.Tensor:
    """[B, size] bool, True = keep: position p is masked where
    start <= p < start + width."""
    pos = torch.arange(size, device=width.device)[None, :]
    return ~((pos >= start[:, None]) & (pos < (start + width)[:, None]))


def spec_augment(generator: torch.Generator, feat: torch.Tensor, lengths: torch.Tensor,
                 cfg: FrontendConfig) -> torch.Tensor:
    """Apply SpecAugment masks. feat: [B, T, D]; masked bins are set to 0
    (features are CMVN-normalised, so 0 is the mean). Frequency masks are
    drawn first, then time masks, each width before start."""
    B, T, D = feat.shape
    keep = torch.ones(B, T, D, dtype=torch.bool, device=feat.device)
    full_d = torch.full((B,), D, device=feat.device)
    for _ in range(cfg.specaug_freq_masks):
        keep &= band_keep(D, *draw_bands(generator, B, cfg.specaug_freq_mask, full_d))[:, None, :]
    for _ in range(cfg.specaug_time_masks):
        limit = torch.clamp(lengths, min=1)
        keep &= band_keep(T, *draw_bands(generator, B, cfg.specaug_time_mask, limit))[:, :, None]
    return torch.where(keep, feat, 0.0)
