"""K1, the fused log-mel frontend: wrapper of ``csrc/log_mel.cu`` and its
plain PyTorch version.

Counterpart of ``uasr/frontend/pallas_frontend.py`` (TPU kernel
``_log_mel_fused_kernel``). Raw audio goes in; framing, the folded
pre-emphasis + window DFT, power, the mel product and the log floor run
in one kernel and neither frames nor power reach device memory.

``log_mel_fused`` launches the kernel for CUDA tensors and runs
``log_mel_fused_reference`` for CPU tensors; nothing else chooses
between them.
"""

from __future__ import annotations

import ctypes

import torch

from uasr_torch import _build
from uasr_torch.config import FrontendConfig
from uasr_torch.frontend.features import _LOG_FLOOR, FrontendState, _gemm, num_frames_static

LAUNCHES = 0  # kernel launches by log_mel_fused (read by chip_smoke.py)

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


def _lib() -> ctypes.CDLL:
    lib = _build.load("log_mel")
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
    lib.uasr_log_mel.argtypes = [P, L, L, L, P, P, P, P, P, I, I, I, I,
                                 ctypes.c_float, I, I, P, I]
    lib.uasr_log_mel.restype = I
    return lib


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
    if precision not in TIERS:
        raise ValueError(f"unknown frontend precision {precision!r}")
    consts = (state.pre_cos, state.pre_sin, state.pre_bvec, state.mel_fb)
    for t in (audio, *consts):
        if t.device != audio.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("log_mel kernel takes contiguous float32 tensors on one device")
    B, L = audio.shape
    NB = n_fft // 2 + 1
    M = state.mel_fb.shape[1]
    if state.pre_cos.shape != (frame_len, NB) or state.mel_fb.shape[0] != NB:
        raise ValueError("frontend state does not match frame_len / n_fft")
    T = num_frames_static(L, frame_len, frame_shift)
    out = torch.empty(B, T, M + int(want_energy), device=audio.device, dtype=torch.float32)
    lib = _lib()
    code = lib.uasr_log_mel(
        audio.data_ptr(), B, L, T, *(c.data_ptr() for c in consts), out.data_ptr(),
        frame_len, frame_shift, NB, M, 1.0 / n_fft, TIERS[precision],
        int(want_energy), torch.cuda.current_stream(audio.device).cuda_stream,
        audio.device.index if audio.device.index is not None else torch.cuda.current_device(),
    )
    _build.check(lib, code, "log_mel kernel")
    LAUNCHES += 1
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
