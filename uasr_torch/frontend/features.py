"""Acoustic frontend in PyTorch (counterpart of ``uasr.frontend.features``).

The whole chain runs on the tensors' device: pre-emphasis,
framing, window, DFT power (as products against precomputed cos/sin
bases), mel, log, MFCC, deltas, CMVN, splice and downsample. Padded
batches reproduce the per-utterance results on the valid frames: CMVN
statistics are masked and delta/splice edges replicate at each
utterance's own end.

With ``FrontendConfig.use_pallas`` the log-mel hot path goes through
``cuda_frontend.log_mel_fused``: the hand-written kernel K1 for CUDA
tensors, its plain PyTorch version for CPU tensors. Otherwise the
unfused path below (pre-emphasis pass, explicit frames, two DFT
products) runs on any device. ``cmvn="streaming"`` goes through the
chunked frontend of ``uasr_torch.frontend.streaming`` (kernel K7).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from uasr_torch import resolve_device
from uasr_torch.config import FrontendConfig
from uasr_torch.frontend import oracle

_LOG_FLOOR = float(np.finfo(np.float64).eps)  # oracle parity


class FrontendState(NamedTuple):
    """Precomputed constant bank (tensors on one device)."""

    window: torch.Tensor  # [frame_len]
    cos_basis: torch.Tensor  # [frame_len, n_bins]
    sin_basis: torch.Tensor  # [frame_len, n_bins]
    mel_fb: torch.Tensor  # [n_bins, num_mel]
    dct: torch.Tensor | None  # [num_mel, num_ceps]
    lifter: torch.Tensor | None  # [num_ceps]
    global_mean: torch.Tensor | None
    global_std: torch.Tensor | None
    # pre-emphasis + window folded into the DFT bases (built in float64):
    # for a RAW frame x[s : s+FL],
    #   DFT_k(window * preemph(frame)) =
    #       x[s : s+FL] @ pre_cos[:, k]  +  x[s-1] * pre_bvec[0, k]
    # (sin likewise with pre_sin / pre_bvec[1]); K1 consumes raw audio.
    pre_cos: torch.Tensor | None = None  # [frame_len, n_bins]
    pre_sin: torch.Tensor | None = None  # [frame_len, n_bins]
    pre_bvec: torch.Tensor | None = None  # [2, n_bins] boundary (cos, sin)
    # each mel filter's run of nonzero bins, for K1 and K7: mel_runs [3,
    # num_mel] int32 holds lo, hi (every mel_fb[k, m] with k outside [lo,
    # hi) is exactly 0) and the run's offset into mel_w, the runs' entries
    # of mel_fb packed filter after filter
    mel_runs: torch.Tensor | None = None
    mel_w: torch.Tensor | None = None
    # the DFT bases in K1's (pre_pack: pre_cos, pre_sin) and K7's (dft_pack:
    # cos, sin) slab layout (pack_bases)
    pre_pack: torch.Tensor | None = None
    dft_pack: torch.Tensor | None = None

    def to(self, device) -> "FrontendState":
        return FrontendState(*(None if x is None else x.to(device) for x in self))


def dft_matrices(frame_len: int, n_fft: int) -> tuple[np.ndarray, np.ndarray]:
    """Real-DFT bases such that rfft(x, n_fft)[k] = x@cos[:,k] - i*(x@sin[:,k])
    for len(x) = frame_len <= n_fft (implicit zero padding)."""
    n = np.arange(frame_len, dtype=np.float64)[:, None]
    k = np.arange(n_fft // 2 + 1, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * n * k / n_fft
    return np.cos(ang), np.sin(ang)


def mel_runs(mel_fb: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """[n_bins, num_mel] filterbank -> (runs [3, num_mel] int32: each
    filter's first and one-past-last nonzero bin and its offset into the
    packed entries, packed [sum of run lengths] entries). A filter with no
    nonzero entry has the empty run [0, 0)."""
    nz = mel_fb != 0
    anyz = nz.any(0)
    lo = np.where(anyz, nz.argmax(0), 0)
    hi = np.where(anyz, mel_fb.shape[0] - nz[::-1].argmax(0), 0)
    off = np.concatenate([[0], np.cumsum(hi - lo)[:-1]])
    w = np.concatenate([mel_fb[a:b, m] for m, (a, b) in enumerate(zip(lo, hi))]
                       + [np.zeros(0, mel_fb.dtype)])
    return np.stack([lo, hi, off]).astype(np.int32), w


PACK_BINS, PACK_ROWS = 256, 16  # csrc/log_mel.cu: bins a pass, slab rows' multiple


def pack_bases(cos_b: np.ndarray, sin_b: np.ndarray) -> np.ndarray:
    """[FL, NB] cos and sin bases -> the flat layout K1 and K7 copy slabs
    of (csrc/log_mel.cu): with NB = 4 n + t, FLP = FL rounded up to 16 and
    P = ceil(4 n / 256) passes, [P, FLP, cos 256 | sin 256] of bins 0 ..
    4 n - 1, then [cos | sin][4][FLP] of the t tail bins, zero elsewhere."""
    FL, NB = cos_b.shape
    nt = NB % 4
    nbm = NB - nt
    npass = max(1, -(-nbm // PACK_BINS))
    flp = -(-FL // PACK_ROWS) * PACK_ROWS
    main = np.zeros((npass, flp, 2, PACK_BINS), np.float32)
    tail = np.zeros((2, 4, flp), np.float32)
    for w, basis in enumerate((cos_b, sin_b)):
        for p in range(npass):
            cols = basis[:, p * PACK_BINS: min(nbm, (p + 1) * PACK_BINS)]
            main[p, :FL, w, :cols.shape[1]] = cols
        tail[w, :nt, :FL] = basis[:, nbm:].T
    return np.concatenate([main.ravel(), tail.ravel()])


def make_frontend_state(
    cfg: FrontendConfig,
    global_mean: np.ndarray | None = None,
    global_std: np.ndarray | None = None,
    dtype=torch.float32,
    device="cuda",
) -> FrontendState:
    device = resolve_device(device)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)

    win = oracle.window_fn(cfg.window, cfg.frame_length)
    cos_b, sin_b = dft_matrices(cfg.frame_length, cfg.n_fft)
    fb = oracle.mel_filterbank(
        cfg.num_mel_bins, cfg.n_fft, cfg.sample_rate, cfg.low_freq,
        cfg.high_freq or cfg.sample_rate / 2.0,
    )
    dct = lift = None
    if cfg.feature_type == "mfcc":
        n = cfg.num_mel_bins
        k = np.arange(cfg.num_ceps, dtype=np.float64)[:, None]
        tt = np.arange(n, dtype=np.float64)[None, :]
        basis = np.cos(np.pi * k * (2 * tt + 1) / (2 * n))
        scale = np.full((cfg.num_ceps, 1), np.sqrt(2.0 / n))
        scale[0, 0] = np.sqrt(1.0 / n)
        dct = t((basis * scale).T)  # [num_mel, num_ceps]
        if cfg.cep_lifter > 0:
            idx = np.arange(cfg.num_ceps, dtype=np.float64)
            lift = t(1.0 + (cfg.cep_lifter / 2.0) * np.sin(np.pi * idx / cfg.cep_lifter))
        else:
            lift = t(np.ones(cfg.num_ceps))
    # window + pre-emphasis folded bases; the shift-by-one combination is
    # exact in float64
    p = float(cfg.preemph)
    wc = win[:, None] * cos_b  # [FL, NB] float64
    ws = win[:, None] * sin_b
    zrow = np.zeros((1, wc.shape[1]), np.float64)
    pre_cos = wc - p * np.vstack([wc[1:], zrow])
    pre_sin = ws - p * np.vstack([ws[1:], zrow])
    pre_bvec = -p * np.stack([wc[0], ws[0]])  # [2, NB]
    runs, mel_w = mel_runs(np.asarray(fb.T, np.float32))  # of mel_fb as stored
    return FrontendState(
        window=t(win),
        cos_basis=t(cos_b),
        sin_basis=t(sin_b),
        mel_fb=t(fb.T),  # [n_bins, num_mel]
        dct=dct,
        lifter=lift,
        global_mean=None if global_mean is None else t(global_mean),
        global_std=None if global_std is None else t(global_std),
        pre_cos=t(pre_cos),
        pre_sin=t(pre_sin),
        pre_bvec=t(pre_bvec),
        mel_runs=torch.as_tensor(runs, device=device),
        mel_w=t(mel_w),
        pre_pack=t(pack_bases(np.float32(pre_cos), np.float32(pre_sin))),
        dft_pack=t(pack_bases(np.float32(cos_b), np.float32(sin_b))),
    )


def frontend_state_from_config(
    cfg: FrontendConfig, dtype=torch.float32, device="cuda"
) -> FrontendState:
    """Build the constant bank, loading dataset-level CMVN statistics
    from ``cfg.cmvn_stats_path`` when ``cmvn == "global"``."""
    mean = std = None
    if cfg.cmvn == "global":
        if not cfg.cmvn_stats_path:
            raise ValueError("frontend.cmvn='global' requires frontend.cmvn_stats_path")
        z = np.load(cfg.cmvn_stats_path)
        mean, std = z["mean"], z["std"]
        if mean.shape[-1] != cfg.base_dim:
            raise ValueError(
                f"CMVN stats dim {mean.shape[-1]} != frontend base_dim "
                f"{cfg.base_dim} ({cfg.cmvn_stats_path})"
            )
    return make_frontend_state(cfg, mean, std, dtype, device)


def num_frames(num_samples, frame_len: int, frame_shift: int):
    """Oracle framing count: 1 + floor((L - frame_len)/shift), min 1."""
    return torch.clamp(
        1 + torch.div(num_samples - frame_len, frame_shift, rounding_mode="floor"),
        min=1,
    )


def num_frames_static(L: int, frame_len: int, frame_shift: int) -> int:
    """Frames of a padded [.., L] batch: ``num_frames`` for one length."""
    return max(1 + (L - frame_len) // frame_shift, 1)


def frame_audio(audio: torch.Tensor, frame_len: int, frame_shift: int) -> torch.Tensor:
    """[B, L] -> [B, T, frame_len] overlapping frames (gather)."""
    L = audio.shape[-1]
    T = num_frames_static(L, frame_len, frame_shift)
    idx = np.arange(frame_len)[None, :] + frame_shift * np.arange(T)[:, None]
    idx = np.minimum(idx, L - 1)  # only reachable when L < frame_len
    return audio[..., torch.as_tensor(idx, device=audio.device)]


def preemphasize(audio: torch.Tensor, k: float) -> torch.Tensor:
    return torch.cat([audio[..., :1], audio[..., 1:] - k * audio[..., :-1]], -1)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def _gemm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """Frontend product at the configured tier: "highest" = f32 (no TF32),
    "high" = bf16 hi/lo split a@b ~ ah@bh + ah@bl + al@bh, "bfloat16" =
    bf16 operands. Products of bf16 values are exact in f32, so the lower
    tiers are f32 products of rounded operands with f32 accumulation."""
    if precision == "bfloat16":
        return _bf16(a) @ _bf16(b)
    if precision == "high":
        ah, bh = _bf16(a), _bf16(b)
        al, bl = _bf16(a - ah), _bf16(b - bh)
        return ah @ bh + ah @ bl + al @ bh
    if precision != "highest":
        raise ValueError(f"unknown frontend precision {precision!r}")
    return a @ b


def power_frames(
    frames: torch.Tensor, state: FrontendState, n_fft: int, precision: str = "highest"
) -> torch.Tensor:
    """Windowed frames -> power spectrum via two products."""
    w = frames * state.window
    re = _gemm(w, state.cos_basis, precision)
    im = _gemm(w, state.sin_basis, precision)
    return (re * re + im * im) * (1.0 / n_fft)


def log_mel_frontend(
    audio: torch.Tensor, state: FrontendState, cfg: FrontendConfig
) -> torch.Tensor:
    """[B, L] waveform -> [B, T, num_mel] log-mel (unfused path)."""
    x = preemphasize(audio, cfg.preemph)
    frames = frame_audio(x, cfg.frame_length, cfg.frame_shift)
    pspec = power_frames(frames, state, cfg.n_fft, cfg.precision)
    return torch.log(torch.clamp(_gemm(pspec, state.mel_fb, cfg.precision), min=_LOG_FLOOR))


def _mfcc_from_logmel(
    logmel: torch.Tensor, pspec_energy, state: FrontendState, cfg: FrontendConfig
) -> torch.Tensor:
    ceps = (logmel @ state.dct) * state.lifter
    if cfg.use_energy:
        loge = torch.log(torch.clamp(pspec_energy, min=_LOG_FLOOR))
        ceps = torch.cat([loge[..., None], ceps[..., 1:]], -1)
    return ceps


def _clip_gather(feat: torch.Tensor, offsets: list[int], lengths: torch.Tensor):
    """For each offset, gather feat[t+off] with t+off clipped to
    [0, length-1] per utterance (edge replication at the true utterance
    end). feat: [B, T, D]."""
    B, T, D = feat.shape
    t = torch.arange(T, device=feat.device)[None, :]
    hi = (lengths - 1)[:, None]
    outs = []
    for off in offsets:
        idx = torch.minimum(torch.clamp(t + off, min=0), hi).clamp(min=0)  # [B, T]
        outs.append(torch.gather(feat, 1, idx[:, :, None].expand(B, T, D)))
    return outs


def add_deltas(feat: torch.Tensor, lengths: torch.Tensor, N: int) -> torch.Tensor:
    """Append delta + delta-delta (regression window N, edge-replicated)."""

    def one_delta(f):
        denom = 2.0 * sum(i * i for i in range(1, N + 1))
        acc = torch.zeros_like(f)
        for n in range(1, N + 1):
            plus, minus = _clip_gather(f, [n, -n], lengths)
            acc = acc + n * (plus - minus)
        return acc / denom

    d1 = one_delta(feat)
    d2 = one_delta(d1)
    return torch.cat([feat, d1, d2], dim=-1)


def _frame_mask(T: int, lengths: torch.Tensor) -> torch.Tensor:
    return (torch.arange(T, device=lengths.device)[None, :] < lengths[:, None])[..., None]


def apply_cmvn(
    feat: torch.Tensor, lengths: torch.Tensor, cfg: FrontendConfig,
    state: FrontendState, eps: float = 1e-8,
) -> torch.Tensor:
    """Masked per-utterance or precomputed-global CMVN."""
    if cfg.cmvn == "none":
        return feat
    if cfg.cmvn == "global":
        if state.global_mean is None:
            raise ValueError("cmvn='global' but the FrontendState has no stats")
        return (feat - state.global_mean) / (state.global_std + eps)
    mask = _frame_mask(feat.shape[1], lengths)
    n = torch.clamp(lengths, min=1).to(feat.dtype)[:, None, None]
    mu = torch.sum(feat * mask, dim=1, keepdim=True) / n
    var = torch.sum(torch.square(feat - mu) * mask, dim=1, keepdim=True) / n
    return torch.where(mask, (feat - mu) / (torch.sqrt(var) + eps), 0.0)


def splice_and_downsample(
    feat: torch.Tensor, lengths: torch.Tensor, cfg: FrontendConfig
) -> tuple[torch.Tensor, torch.Tensor]:
    """Splice +-context then keep every k-th frame."""
    if cfg.splice_left or cfg.splice_right:
        offs = list(range(-cfg.splice_left, cfg.splice_right + 1))
        feat = torch.cat(_clip_gather(feat, offs, lengths), dim=-1)
    if cfg.downsample > 1:
        feat = feat[:, :: cfg.downsample]
        lengths = torch.div(lengths + cfg.downsample - 1, cfg.downsample,
                            rounding_mode="floor")
    return feat, lengths


def compute_features(
    audio: torch.Tensor,
    audio_lengths: torch.Tensor,
    state: FrontendState,
    cfg: FrontendConfig,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Full frontend: [B, L] waveform (+ lengths) -> ([B, T, D], lengths).

    Frames past an utterance's length are zeroed."""
    if cfg.cmvn == "streaming":
        # causal chunked frontend with running CMVN: frame t ends at sample
        # (t+1)*frame_shift and is normalised by statistics of frames <= t
        from uasr_torch.frontend.streaming import streaming_features

        feat = streaming_features(audio, state, cfg)
        lengths = torch.clamp(torch.div(audio_lengths + cfg.frame_shift - 1, cfg.frame_shift,
                                        rounding_mode="floor"), max=feat.shape[1])
        if cfg.add_deltas:
            feat = add_deltas(feat, lengths, cfg.delta_window)
        feat, lengths = splice_and_downsample(feat, lengths, cfg)
        return feat * _frame_mask(feat.shape[1], lengths), lengths
    if cfg.use_pallas:
        from uasr_torch.frontend.cuda_frontend import log_mel_fused

        want_e = cfg.feature_type == "mfcc" and cfg.use_energy
        feat = log_mel_fused(audio, state, cfg, precision=cfg.precision,
                             want_energy=want_e)
        if cfg.feature_type == "mfcc":
            if want_e:
                loge, feat = feat[..., -1], feat[..., :-1]
                ceps = (feat @ state.dct) * state.lifter
                feat = torch.cat([loge[..., None], ceps[..., 1:]], -1)
            else:
                feat = _mfcc_from_logmel(feat, None, state, cfg)
    else:
        x = preemphasize(audio, cfg.preemph)
        frames = frame_audio(x, cfg.frame_length, cfg.frame_shift)
        pspec = power_frames(frames, state, cfg.n_fft, cfg.precision)
        feat = torch.log(torch.clamp(_gemm(pspec, state.mel_fb, cfg.precision),
                                     min=_LOG_FLOOR))
        if cfg.feature_type == "mfcc":
            feat = _mfcc_from_logmel(feat, pspec.sum(-1), state, cfg)
    lengths = num_frames(audio_lengths, cfg.frame_length, cfg.frame_shift)
    lengths = torch.clamp(lengths, max=feat.shape[1])
    if cfg.add_deltas:
        feat = add_deltas(feat, lengths, cfg.delta_window)
    feat = apply_cmvn(feat, lengths, cfg, state)
    feat, lengths = splice_and_downsample(feat, lengths, cfg)
    return feat * _frame_mask(feat.shape[1], lengths), lengths
