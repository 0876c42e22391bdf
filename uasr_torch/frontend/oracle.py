"""Window and mel-filterbank constants (copy of the float64 numpy parts
of ``uasr.frontend.oracle`` that the frontend's constant bank needs)."""

from __future__ import annotations

import numpy as np


def window_fn(name: str, n: int) -> np.ndarray:
    """Periodic-symmetric analysis windows.

    'hamming'/'hann' are the symmetric numpy windows (what
    python_speech_features users pass); 'povey' is Kaldi's default
    (hann ** 0.85); 'rect' is python_speech_features' default (ones).
    """
    t = np.arange(n, dtype=np.float64)
    if name == "rect":
        return np.ones(n, dtype=np.float64)
    if name == "hamming":
        return 0.54 - 0.46 * np.cos(2 * np.pi * t / (n - 1))
    if name == "hann":
        return 0.5 - 0.5 * np.cos(2 * np.pi * t / (n - 1))
    if name == "povey":
        return (0.5 - 0.5 * np.cos(2 * np.pi * t / (n - 1))) ** 0.85
    raise ValueError(f"unknown window {name!r}")


def hz2mel(hz):
    return 2595.0 * np.log10(1.0 + np.asarray(hz, dtype=np.float64) / 700.0)


def mel2hz(mel):
    return 700.0 * (10.0 ** (np.asarray(mel, dtype=np.float64) / 2595.0) - 1.0)


def mel_filterbank(
    num_bins: int, n_fft: int, sample_rate: float, low_freq: float, high_freq: float
) -> np.ndarray:
    """python_speech_features-style triangular filterbank, shape
    [num_bins, n_fft // 2 + 1], built on integer FFT-bin centers."""
    high_freq = high_freq or sample_rate / 2.0
    if high_freq > sample_rate / 2.0:
        raise ValueError(f"high_freq {high_freq} above Nyquist")
    lowmel, highmel = hz2mel(low_freq), hz2mel(high_freq)
    melpoints = np.linspace(lowmel, highmel, num_bins + 2)
    # round center freqs to fft bins
    bins = np.floor((n_fft + 1) * mel2hz(melpoints) / sample_rate).astype(np.int64)
    fbank = np.zeros((num_bins, n_fft // 2 + 1), dtype=np.float64)
    for j in range(num_bins):
        for i in range(int(bins[j]), int(bins[j + 1])):
            fbank[j, i] = (i - bins[j]) / max(bins[j + 1] - bins[j], 1)
        for i in range(int(bins[j + 1]), int(bins[j + 2])):
            fbank[j, i] = (bins[j + 2] - i) / max(bins[j + 2] - bins[j + 1], 1)
    return fbank
