"""The least time of a piece of work, and the frontend's constants."""

from __future__ import annotations

import functools

import numpy as np


def bound_s(nbytes: float, ops: float, dtype: str, peaks: dict) -> float:
    """The larger of bytes over bandwidth and operations over the peak."""
    return max(nbytes / peaks["bytes_per_s"], ops / peaks["flops"][dtype])


def frontend_dims(fe: dict) -> dict:
    sr = fe.get("sample_rate", 16000)
    n_fft = fe.get("n_fft", 512)
    return {"FL": int(round(sr * fe.get("frame_length_ms", 25.0) / 1000)),
            "FS": int(round(sr * fe.get("frame_shift_ms", 10.0) / 1000)),
            "NB": n_fft // 2 + 1, "M": fe["num_mel_bins"],
            "nnz": mel_nonzeros(fe["num_mel_bins"], n_fft, sr)}


@functools.lru_cache(maxsize=None)
def mel_nonzeros(num_bins: int, n_fft: int, sr: int) -> int:
    """Nonzero entries of the mel filterbank (the mel product's work)."""
    from benchmark.reference.fbank import mel_filterbank

    return int(np.count_nonzero(mel_filterbank(num_bins, n_fft, sr, 0.0, sr / 2.0)))


def model_dtype(conf: dict) -> str:
    return conf["recipe"]["model"].get("dtype", "float32")
