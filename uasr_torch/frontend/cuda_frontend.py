"""K1, the fused log-mel frontend, and K7, the unfused log-mel of the
streaming frontend: wrappers of ``csrc/log_mel.cu`` and their plain
PyTorch versions.

Counterparts of ``uasr/frontend/pallas_frontend.py``. K1 (TPU kernel
``_log_mel_fused_kernel``): raw audio goes in; framing, the folded
pre-emphasis + window DFT, power, the mel product and the log floor run
in one kernel and neither frames nor power reach device memory. K7 (TPU
kernel ``_log_mel_kernel``, ``_pallas_log_mel(fused=False)``): the input
is already pre-emphasised (the streaming frontend's glued chunk) and the
kernel multiplies the window in itself.

``log_mel_fused`` and ``log_mel_unfused`` launch their kernels for CUDA
tensors and run the plain versions for CPU tensors; nothing else
chooses between them.
"""

from __future__ import annotations

import ctypes

import torch

from uasr_torch import _build
from uasr_torch.config import FrontendConfig
from uasr_torch.frontend.features import (
    _LOG_FLOOR, FrontendState, _gemm, frame_audio, num_frames_static,
)

LAUNCHES = 0  # K1 launches by log_mel_fused (read by chip_smoke.py)
LAUNCHES_UNFUSED = 0  # K7 launches by log_mel_unfused

TIERS = {"highest": 0, "high": 1, "bfloat16": 2}


def log_mel_fused_reference(
    audio: torch.Tensor,
    state: FrontendState,
    frame_len: int,
    frame_shift: int,
    n_fft: int,
    precision: str = "highest",
    want_energy: bool = False,
) -> torch.Tensor:
    """Plain version of K1: [B, L] raw audio -> [B, T, M (+1)] log-mel."""
    B, L = audio.shape
    FL, FS = frame_len, frame_shift
    T = num_frames_static(L, FL, FS)
    dev = audio.device
    idx = torch.arange(FL, device=dev)[None, :] + FS * torch.arange(T, device=dev)[:, None]
    frames = audio[:, torch.clamp(idx, max=L - 1)]  # [B, T, FL]
    prev = FS * torch.arange(T, device=dev) - 1  # x[s-1]; x[-1] = 0
    bcol = torch.where(prev >= 0, audio[:, torch.clamp(prev, 0, L - 1)], 0.0)
    bc = bcol[..., None]
    re = _gemm(frames, state.pre_cos, precision) + bc * state.pre_bvec[0]
    im = _gemm(frames, state.pre_sin, precision) + bc * state.pre_bvec[1]
    power = (re * re + im * im) * (1.0 / n_fft)
    out = torch.log(torch.clamp(_gemm(power, state.mel_fb, precision), min=_LOG_FLOOR))
    if want_energy:
        loge = torch.log(torch.clamp(power.sum(-1), min=_LOG_FLOOR))
        out = torch.cat([out, loge[..., None]], -1)
    return out


def log_mel_unfused_reference(
    audio: torch.Tensor,
    state: FrontendState,
    frame_len: int,
    frame_shift: int,
    n_fft: int,
    precision: str = "highest",
    want_energy: bool = False,
) -> torch.Tensor:
    """Plain version of K7: [B, L] pre-emphasised audio -> [B, T, M (+1)]
    log-mel, the window multiplied into each frame."""
    w = frame_audio(audio, frame_len, frame_shift) * state.window
    re = _gemm(w, state.cos_basis, precision)
    im = _gemm(w, state.sin_basis, precision)
    power = (re * re + im * im) * (1.0 / n_fft)
    out = torch.log(torch.clamp(_gemm(power, state.mel_fb, precision), min=_LOG_FLOOR))
    if want_energy:
        loge = torch.log(torch.clamp(power.sum(-1), min=_LOG_FLOOR))
        out = torch.cat([out, loge[..., None]], -1)
    return out


def _lib() -> ctypes.CDLL:
    lib = _build.load("log_mel")
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
    for fn in (lib.uasr_log_mel, lib.uasr_log_mel_unfused):
        fn.argtypes = [P, L, L, L, P, P, P, P, P, I, I, I, I, ctypes.c_float, I, I, P, I]
        fn.restype = I
    return lib


def _launch(entry: str, audio: torch.Tensor, consts: tuple, mel_fb: torch.Tensor,
            frame_len: int, frame_shift: int, n_fft: int, precision: str,
            want_energy: bool) -> torch.Tensor:
    """Check the operands and launch one of the two kernels of log_mel.cu."""
    if precision not in TIERS:
        raise ValueError(f"unknown frontend precision {precision!r}")
    for t in (audio, *consts, mel_fb):
        if t.device != audio.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("log_mel kernel takes contiguous float32 tensors on one device")
    B, L = audio.shape
    NB = n_fft // 2 + 1
    M = mel_fb.shape[1]
    if consts[1].shape != (frame_len, NB) or mel_fb.shape[0] != NB:  # a sin or cos basis
        raise ValueError("frontend state does not match frame_len / n_fft")
    T = num_frames_static(L, frame_len, frame_shift)
    out = torch.empty(B, T, M + int(want_energy), device=audio.device, dtype=torch.float32)
    lib = _lib()
    code = getattr(lib, entry)(
        audio.data_ptr(), B, L, T, *(c.data_ptr() for c in consts), mel_fb.data_ptr(),
        out.data_ptr(), frame_len, frame_shift, NB, M, 1.0 / n_fft, TIERS[precision],
        int(want_energy), torch.cuda.current_stream(audio.device).cuda_stream,
        audio.device.index if audio.device.index is not None else torch.cuda.current_device(),
    )
    _build.check(lib, code, "log_mel kernel")
    return out


def log_mel_fused_cuda(
    audio: torch.Tensor,
    state: FrontendState,
    frame_len: int,
    frame_shift: int,
    n_fft: int,
    precision: str = "highest",
    want_energy: bool = False,
) -> torch.Tensor:
    """Launch K1 on CUDA tensors; same contract as the plain version."""
    global LAUNCHES
    out = _launch("uasr_log_mel", audio, (state.pre_cos, state.pre_sin, state.pre_bvec),
                  state.mel_fb, frame_len, frame_shift, n_fft, precision, want_energy)
    LAUNCHES += 1
    return out


def log_mel_unfused_cuda(
    audio: torch.Tensor,
    state: FrontendState,
    frame_len: int,
    frame_shift: int,
    n_fft: int,
    precision: str = "highest",
    want_energy: bool = False,
) -> torch.Tensor:
    """Launch K7 on CUDA tensors; same contract as the plain version."""
    global LAUNCHES_UNFUSED
    out = _launch("uasr_log_mel_unfused", audio,
                  (state.window, state.cos_basis, state.sin_basis), state.mel_fb,
                  frame_len, frame_shift, n_fft, precision, want_energy)
    LAUNCHES_UNFUSED += 1
    return out


def log_mel_fused(
    audio: torch.Tensor,
    state: FrontendState,
    cfg: FrontendConfig,
    precision: str = "highest",
    want_energy: bool = False,
) -> torch.Tensor:
    """[B, L] raw audio -> [B, T, M] log-mel ([B, T, M+1] with the log
    total power column when ``want_energy``): K1 for CUDA tensors, the
    plain version for CPU tensors."""
    if state.pre_cos is None:
        raise ValueError("fused log-mel needs a state with folded bases (make_frontend_state)")
    fn = log_mel_fused_cuda if audio.is_cuda else log_mel_fused_reference
    return fn(audio, state, cfg.frame_length, cfg.frame_shift, cfg.n_fft,
              precision=precision, want_energy=want_energy)


def log_mel_unfused(
    audio: torch.Tensor,
    state: FrontendState,
    cfg: FrontendConfig,
    precision: str = "highest",
    want_energy: bool = False,
) -> torch.Tensor:
    """[B, L] pre-emphasised audio -> [B, T, M] log-mel ([B, T, M+1] with
    the log total power column when ``want_energy``): K7 for CUDA
    tensors, the plain version for CPU tensors."""
    fn = log_mel_unfused_cuda if audio.is_cuda else log_mel_unfused_reference
    return fn(audio, state, cfg.frame_length, cfg.frame_shift, cfg.n_fft,
              precision=precision, want_energy=want_energy)
