"""Streaming frontend: chunked feature extraction with a causal running
CMVN carried across chunks (counterpart of ``uasr.frontend.streaming``).

Each frame is normalised with the statistics of the frames seen so far
(itself included) plus a warm-up prior, so an utterance gives the same
features whether it arrives whole or in chunks. ``stream_chunk`` is the
step (state, chunk) -> (state, features); ``streaming_features`` loops
it over the chunks of a whole utterance, as the JAX package's
``lax.scan`` does, so offline and streamed features come from the same
arithmetic, one log-mel launch per chunk.

The log-mel of a chunk is ``cuda_frontend.log_mel_unfused`` when
``FrontendConfig.use_pallas``: kernel K7 for CUDA tensors, its plain
version for CPU tensors. Otherwise the framing + two DFT products of
``features`` run on any device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from uasr_torch.config import FrontendConfig
from uasr_torch.frontend.features import (
    _LOG_FLOOR, FrontendState, _gemm, frame_audio, power_frames,
)


class StreamState(NamedTuple):
    """Running CMVN statistics, and the audio overlap tail and
    pre-emphasis carry that glue chunk boundaries."""

    count: torch.Tensor  # [B, 1]
    total: torch.Tensor  # [B, D]
    total_sq: torch.Tensor  # [B, D]
    tail: torch.Tensor  # [B, frame_len - frame_shift] pre-emphasised samples
    last_sample: torch.Tensor  # [B, 1] raw sample, for pre-emphasis


def init_stream_state(batch: int, cfg: FrontendConfig, dtype=torch.float32,
                      device="cpu") -> StreamState:
    D = cfg.num_mel_bins
    z = lambda n: torch.zeros(batch, n, dtype=dtype, device=device)  # noqa: E731
    return StreamState(z(1), z(D), z(D), z(cfg.frame_length - cfg.frame_shift), z(1))


def stream_chunk(
    state: StreamState,
    audio_chunk: torch.Tensor,
    fe: FrontendState,
    cfg: FrontendConfig,
    prior_count: float = 8.0,
    eps: float = 1e-8,
    use_pallas: bool | None = None,
) -> tuple[StreamState, torch.Tensor]:
    """One chunk of S samples (a multiple of frame_shift) -> (new state,
    features [B, S // frame_shift, D]), each frame normalised causally.

    The glued chunk of (frame_len - frame_shift) + S samples yields
    exactly S / frame_shift frames. ``use_pallas`` overrides
    ``cfg.use_pallas`` (K7 on CUDA tensors, its plain version on CPU)."""
    B, S = audio_chunk.shape
    FS, FL = cfg.frame_shift, cfg.frame_length
    if S % FS:
        raise ValueError(f"chunk of {S} samples is not a multiple of the frame shift {FS}")
    n_frames = S // FS

    # pre-emphasis with the raw last sample carried across the boundary
    prev = torch.cat([state.last_sample, audio_chunk[:, :-1]], 1)
    x = audio_chunk - cfg.preemph * prev
    glued = torch.cat([state.tail, x], 1)  # [B, overlap + S]
    if cfg.use_pallas if use_pallas is None else use_pallas:
        from uasr_torch.frontend.cuda_frontend import log_mel_unfused

        logmel = log_mel_unfused(glued, fe, cfg, precision=cfg.precision)[:, :n_frames]
    else:
        frames = frame_audio(glued, FL, FS)[:, :n_frames]
        pspec = power_frames(frames, fe, cfg.n_fft, cfg.precision)
        logmel = torch.log(torch.clamp(_gemm(pspec, fe.mel_fb, cfg.precision), min=_LOG_FLOOR))

    # frame t is normalised with the statistics of frames <= t: cumulative
    # within the chunk, seeded by the carried totals
    csum = state.total[:, None, :] + torch.cumsum(logmel, 1)
    csum_sq = state.total_sq[:, None, :] + torch.cumsum(logmel ** 2, 1)
    cnt = state.count[:, :, None] + torch.arange(
        1, n_frames + 1, dtype=logmel.dtype, device=logmel.device)[None, :, None]
    mean = csum / cnt
    var = torch.clamp(csum_sq / cnt - mean ** 2, min=0.0)
    w = cnt / (cnt + prior_count)  # warm-up prior: variance shrinks toward 1
    var = w * var + (1.0 - w) * 1.0
    feats = (logmel - w * mean) / (torch.sqrt(var) + eps)
    new_state = StreamState(
        count=state.count + n_frames,
        total=csum[:, -1, :],
        total_sq=csum_sq[:, -1, :],
        tail=glued[:, glued.shape[1] - (FL - FS):],
        last_sample=audio_chunk[:, -1:],
    )
    return new_state, feats


def streaming_features(
    audio: torch.Tensor,
    fe: FrontendState,
    cfg: FrontendConfig,
    use_pallas: bool | None = None,
) -> torch.Tensor:
    """Offline driver: the utterance, zero-padded to whole chunks, through
    ``stream_chunk`` one chunk at a time. [B, L] -> [B, n_chunks * C, D]."""
    B, L = audio.shape
    C = cfg.streaming_chunk_frames or 64
    S = C * cfg.frame_shift
    n_chunks = max(-(-L // S), 1)
    audio = torch.nn.functional.pad(audio, (0, n_chunks * S - L))
    state = init_stream_state(B, cfg, audio.dtype, audio.device)
    feats = []
    for i in range(n_chunks):
        state, f = stream_chunk(state, audio[:, i * S:(i + 1) * S], fe, cfg,
                                use_pallas=use_pallas)
        feats.append(f)
    return torch.cat(feats, 1)
