"""Batch container of the decode path (``uasr.data.dataset.Batch``).

The rest of the data layer (bucketing, loaders, synthetic corpora)
comes with the training slice.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class Batch(NamedTuple):
    audio: np.ndarray  # [B, L] float32 (or [B, T, D] precomputed features)
    audio_lengths: np.ndarray  # [B] int32
    labels: np.ndarray  # [B, U] int32
    label_lengths: np.ndarray  # [B] int32
