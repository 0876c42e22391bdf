"""Log-mel filterbank features, plain PyTorch (python_speech_features
conventions, as the recipes state them).

Pre-emphasis y[0] = x[0], y[t] = x[t] - k x[t-1]; 25 ms frames every 10 ms
from sample 0, ``1 + (L - frame_len) // shift`` of them; a symmetric
Hamming window; power (1 / n_fft) |DFT|^2 over n_fft // 2 + 1 bins, by
products against cos and sin bases; HTK mel triangles on integer FFT bins;
natural log floored at float64's eps. Utterance CMVN: masked per-utterance
mean and population variance, (x - mean) / (std + 1e-8), zero past the
length. Streaming CMVN: each frame normalised by the running statistics of
the frames up to it, with a warm-up prior of 8 frames of unit variance;
the streamed utterance is zero-padded to whole chunks and framed as if 240
zero samples preceded it, so frame t ends at sample (t + 1) * shift.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference.precision import Cast

LOG_FLOOR = float(np.finfo(np.float64).eps)


def hz2mel(hz):
    return 2595.0 * np.log10(1.0 + np.asarray(hz, dtype=np.float64) / 700.0)


def mel2hz(mel):
    return 700.0 * (10.0 ** (np.asarray(mel, dtype=np.float64) / 2595.0) - 1.0)


def mel_filterbank(num_bins: int, n_fft: int, sample_rate: float, low: float,
                   high: float) -> np.ndarray:
    """Triangular filters on integer FFT-bin centres, [num_bins, n_fft // 2 + 1]."""
    pts = np.linspace(hz2mel(low), hz2mel(high), num_bins + 2)
    bins = np.floor((n_fft + 1) * mel2hz(pts) / sample_rate).astype(np.int64)
    fb = np.zeros((num_bins, n_fft // 2 + 1))
    for j in range(num_bins):
        a, b, c = int(bins[j]), int(bins[j + 1]), int(bins[j + 2])
        for i in range(a, b):
            fb[j, i] = (i - a) / max(b - a, 1)
        for i in range(b, c):
            fb[j, i] = (c - i) / max(c - b, 1)
    return fb


class Fbank:
    """The constants of one frontend recipe on one device."""

    def __init__(self, fe: dict, device, cast: Cast | None = None):
        self.sr = fe.get("sample_rate", 16000)
        self.fl = int(round(self.sr * fe.get("frame_length_ms", 25.0) / 1000.0))
        self.fs = int(round(self.sr * fe.get("frame_shift_ms", 10.0) / 1000.0))
        self.n_fft = fe.get("n_fft", 512)
        self.k = fe.get("preemph", 0.97)
        self.mels = fe["num_mel_bins"]
        self.chunk = fe.get("streaming_chunk_frames", 0) or 64
        if fe.get("window", "hamming") != "hamming" or fe.get("feature_type", "fbank") != "fbank":
            raise ValueError("the reference covers hamming-window fbank features")
        t = np.arange(self.fl, dtype=np.float64)
        win = 0.54 - 0.46 * np.cos(2 * np.pi * t / (self.fl - 1))
        k = np.arange(self.n_fft // 2 + 1, dtype=np.float64)[None, :]
        ang = 2.0 * np.pi * t[:, None] * k / self.n_fft
        f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=device)  # noqa: E731
        self.win = f32(win)
        self.cos, self.sin = f32(np.cos(ang)), f32(np.sin(ang))
        high = fe.get("high_freq") or self.sr / 2.0
        self.mel = f32(mel_filterbank(self.mels, self.n_fft, self.sr, fe.get("low_freq", 0.0),
                                      high).T)
        self.cast = cast or Cast()

    def num_frames(self, samples: int) -> int:
        return max(1 + (samples - self.fl) // self.fs, 1)

    def _log_mel(self, x: torch.Tensor, n: int) -> torch.Tensor:
        """[B, L'] pre-emphasised samples -> [B, n, mels] from frames at
        0, shift, 2 shift, ..."""
        idx = torch.arange(self.fl, device=x.device)[None, :] + self.fs * torch.arange(
            n, device=x.device)[:, None]
        frames = x[:, idx.clamp(max=x.shape[1] - 1)] * self.win
        c = self.cast
        re, im = c(frames) @ c(self.cos), c(frames) @ c(self.sin)
        power = (re * re + im * im) / self.n_fft
        return torch.log((c(power) @ c(self.mel)).clamp_min(LOG_FLOOR))

    def _preemph(self, audio: torch.Tensor) -> torch.Tensor:
        return torch.cat([audio[:, :1], audio[:, 1:] - self.k * audio[:, :-1]], 1)

    def utterance(self, audio: torch.Tensor, lengths: torch.Tensor):
        """[B, L] audio (zero past each length) -> (features [B, T, mels]
        with utterance CMVN, frame lengths [B])."""
        T = self.num_frames(audio.shape[1])
        feat = self._log_mel(self._preemph(audio), T)
        flen = (1 + torch.div(lengths - self.fl, self.fs, rounding_mode="floor")).clamp(1, T)
        mask = (torch.arange(T, device=audio.device)[None, :] < flen[:, None])[..., None]
        n = flen.to(torch.float32)[:, None, None]
        mu = (feat * mask).sum(1, keepdim=True) / n
        var = ((feat - mu) ** 2 * mask).sum(1, keepdim=True) / n
        return torch.where(mask, (feat - mu) / (var.sqrt() + 1e-8), 0.0), flen

    def streaming(self, audio: torch.Tensor, lengths: torch.Tensor, prior: float = 8.0):
        """[B, L] audio -> (features [B, chunks * chunk, mels] with streaming
        CMVN, valid frames ceil(length / shift)), not masked."""
        S = self.chunk * self.fs
        n_chunks = max(math.ceil(audio.shape[1] / S), 1)
        audio = torch.nn.functional.pad(audio, (0, n_chunks * S - audio.shape[1]))
        x = torch.nn.functional.pad(self._preemph(audio), (self.fl - self.fs, 0))
        T, C = n_chunks * self.chunk, self.chunk
        lm = self._log_mel(x, T)
        # running sums carried from chunk to chunk, as a stream keeps them
        B, D = lm.shape[0], lm.shape[2]
        total, total_sq = lm.new_zeros(B, 1, D), lm.new_zeros(B, 1, D)
        out = []
        for i in range(n_chunks):
            c = lm[:, i * C:(i + 1) * C]
            csum, csq = total + c.cumsum(1), total_sq + (c ** 2).cumsum(1)
            cnt = i * C + torch.arange(1, C + 1, device=lm.device, dtype=lm.dtype)[None, :, None]
            mean = csum / cnt
            var = (csq / cnt - mean ** 2).clamp_min(0.0)
            w = cnt / (cnt + prior)
            var = w * var + (1.0 - w)
            out.append((c - w * mean) / (var.sqrt() + 1e-8))
            total, total_sq = csum[:, -1:], csq[:, -1:]
        valid = torch.div(lengths + self.fs - 1, self.fs, rounding_mode="floor").clamp(max=T)
        return torch.cat(out, 1), valid
