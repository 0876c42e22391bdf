"""The numpy frontend oracle (copy of the float64 parts of
``uasr.frontend.oracle``): the window and mel-filterbank constants of
the frontend's constant bank, and the log-mel / MFCC / delta stages that
``data.dataset.compute_cmvn_stats`` runs for ``prepare cmvn``.

Conventions (python_speech_features compatible): pre-emphasis y[0] = x[0],
y[t] = x[t] - k x[t-1]; frames from sample 0, 1 + (L - frame_len) // shift
of them; power (1 / n_fft) |rfft|^2; HTK mel filters on integer FFT bins;
natural log floored at float64 eps; MFCC as the orthonormal DCT-II with
sinusoidal liftering; deltas by regression with edge replication.
"""

from __future__ import annotations

import numpy as np

from uasr_torch.config import FrontendConfig


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


# ----------------------------------------------------------- core stages


def preemphasis(signal: np.ndarray, k: float) -> np.ndarray:
    signal = np.asarray(signal, dtype=np.float64)
    return np.concatenate([signal[:1], signal[1:] - k * signal[:-1]])


def frame_signal(signal: np.ndarray, frame_len: int, frame_shift: int) -> np.ndarray:
    """[L] -> [N, frame_len]; N = 1 + floor((L - frame_len)/shift) for
    L >= frame_len, else 1 zero-padded frame."""
    L = len(signal)
    if L >= frame_len:
        n = 1 + (L - frame_len) // frame_shift
    else:
        n = 1
        signal = np.pad(signal, (0, frame_len - L))
    idx = np.arange(frame_len)[None, :] + frame_shift * np.arange(n)[:, None]
    return signal[idx]


def power_spectrum(frames: np.ndarray, n_fft: int) -> np.ndarray:
    """(1/n_fft) |rfft|^2 — python_speech_features powspec."""
    spec = np.fft.rfft(frames, n_fft)
    return (1.0 / n_fft) * (spec.real**2 + spec.imag**2)


def log_floor(x: np.ndarray) -> np.ndarray:
    return np.log(np.maximum(x, np.finfo(np.float64).eps))


def dct_ortho(x: np.ndarray, num_ceps: int) -> np.ndarray:
    """DCT-II with ortho norm over the last axis, keeping num_ceps."""
    n = x.shape[-1]
    k = np.arange(num_ceps, dtype=np.float64)[:, None]
    t = np.arange(n, dtype=np.float64)[None, :]
    basis = np.cos(np.pi * k * (2 * t + 1) / (2 * n))
    scale = np.full((num_ceps, 1), np.sqrt(2.0 / n))
    scale[0, 0] = np.sqrt(1.0 / n)
    return x @ (basis * scale).T


def lifter(ceps: np.ndarray, L: float) -> np.ndarray:
    if L <= 0:
        return ceps
    n = np.arange(ceps.shape[-1], dtype=np.float64)
    return ceps * (1.0 + (L / 2.0) * np.sin(np.pi * n / L))


def delta(feat: np.ndarray, N: int) -> np.ndarray:
    """Regression deltas with edge replication, window half-width N."""
    denom = 2.0 * sum(i * i for i in range(1, N + 1))
    padded = np.pad(feat, ((N, N), (0, 0)), mode="edge")
    out = np.zeros_like(feat)
    for n in range(1, N + 1):
        out += n * (padded[N + n : N + n + len(feat)] - padded[N - n : N - n + len(feat)])
    return out / denom


# --------------------------------------------------------------- drivers


def oracle_fbank(signal: np.ndarray, cfg: FrontendConfig) -> np.ndarray:
    """Raw waveform -> log-mel filterbank [T, num_mel_bins]."""
    x = preemphasis(signal, cfg.preemph)
    frames = frame_signal(x, cfg.frame_length, cfg.frame_shift)
    frames = frames * window_fn(cfg.window, cfg.frame_length)[None, :]
    pspec = power_spectrum(frames, cfg.n_fft)
    fb = mel_filterbank(
        cfg.num_mel_bins, cfg.n_fft, cfg.sample_rate, cfg.low_freq,
        cfg.high_freq or cfg.sample_rate / 2.0,
    )
    return log_floor(pspec @ fb.T)


def oracle_mfcc(signal: np.ndarray, cfg: FrontendConfig) -> np.ndarray:
    """Raw waveform -> liftered MFCCs [T, num_ceps]."""
    x = preemphasis(signal, cfg.preemph)
    frames = frame_signal(x, cfg.frame_length, cfg.frame_shift)
    frames = frames * window_fn(cfg.window, cfg.frame_length)[None, :]
    pspec = power_spectrum(frames, cfg.n_fft)
    energy = np.maximum(pspec.sum(axis=1), np.finfo(np.float64).eps)
    fb = mel_filterbank(
        cfg.num_mel_bins, cfg.n_fft, cfg.sample_rate, cfg.low_freq,
        cfg.high_freq or cfg.sample_rate / 2.0,
    )
    logmel = log_floor(pspec @ fb.T)
    ceps = lifter(dct_ortho(logmel, cfg.num_ceps), cfg.cep_lifter)
    if cfg.use_energy:
        ceps[:, 0] = np.log(energy)
    return ceps
