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

``log_mel_fused`` and ``log_mel_unfused`` call the operators
``uasr::log_mel_fused`` and ``uasr::log_mel_unfused`` (``ops/library.py``),
which launch the kernels for CUDA tensors and run the plain versions for
CPU tensors; nothing else chooses between them. The kernels read the
state's packed bases (``pre_pack``, ``dft_pack``) and mel runs
(``mel_runs``, ``mel_w``);
``launch_plan``, a pure function, picks their tile and raises on input
that does not fit shared memory; ``log_mel_*_phases`` run the builds
with phase stamps (``uasr_torch.tools.time_frontend`` reads them).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from uasr_torch import _build
from uasr_torch.config import FrontendConfig
from uasr_torch.frontend.features import (
    _LOG_FLOOR, FrontendState, _gemm, frame_audio, num_frames_static,
)

LAUNCHES = 0  # K1 launches by log_mel_fused (read by chip_smoke.py)
LAUNCHES_UNFUSED = 0  # K7 launches by log_mel_unfused
LAUNCHES_PHASES = 0  # launches of the stamped builds by log_mel_*_phases
# the phases the stamped builds time, in the order of their columns
PHASE_NAMES = ("staging", "dft", "power", "mel_log", "stores")

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


# the kernels' fixed shape (csrc/log_mel.cu): 256 bins a pass, a 3-slab
# ring; the tiles each tier is built for: (R frames a thread, WR warp
# rows), a CTA of 128 WR threads over 4 WR R frames
PASS_BINS, STAGES, MAX_SMEM, SM_SMEM = 256, 3, 232448, 233472
TILES = {"highest": ((8, 2), (4, 2), (4, 1)), "bfloat16": ((8, 2), (4, 2), (4, 1)),
         "high": ((2, 2),)}
# a CTA's fixed cost (ring fill, staging, epilogue) in frames of work
CTA_COST_FRAMES = 8
FORCE_TILE = None  # force a tile (a value of TILES); None: the plan's choice
LAST_PLAN = None  # the last launch's plan (read by tools/time_frontend.py)


def launch_plan(B: int, L: int, frame_len: int, frame_shift: int, n_fft: int,
                precision: str = "highest", unfused: bool = False, sms: int = 132,
                tile: tuple[int, int] | None = None) -> dict:
    """The launch plan of K1 (``unfused`` False) or K7 for [B, L] audio: the
    tile (R frames a thread, WR warp rows: a CTA of 128 WR threads covers
    4 WR R frames), the basis ring's slab rows JS, and the shared bytes, as
    ``csrc/log_mel.cu::make_plan`` lays them out. Of the tier's tiles and
    JS in (16, 8, 4) it takes the one that minimises waves x blocks an SM
    runs at once x (frames a CTA + CTA_COST_FRAMES) on ``sms`` SMs (an SM
    holds one CTA of tile (8, 2), two of the others within its shared
    memory), the larger tile on a tie. Raises ValueError on input whose
    smallest tile does not fit the shared memory a block may use. ``tile``
    forces the tile."""
    if precision not in TIERS:
        raise ValueError(f"unknown frontend precision {precision!r}")
    tiles = TILES[precision]
    if tile is not None:
        if tuple(tile) not in tiles:
            raise ValueError(f"{precision!r} is built for the tiles {tiles}, not {tile}")
        tiles = (tuple(tile),)
    FL, FS = frame_len, frame_shift
    NB = n_fft // 2 + 1
    T = num_frames_static(L, FL, FS)
    nt = NB % 4
    nbm = NB - nt
    npass = -(-nbm // PASS_BINS) if nbm else 1
    pws = -(-NB // 4) * 4
    best, need = None, None
    for R, WR in tiles:
        ft = 4 * WR * R
        for js in (16, 8, 4):
            jl = -(-FL // js) * js
            span = not unfused and FS % 4 == 0 and FS >= js
            if span:  # the span, SK floats more after every FS samples
                sk, n = (4 if (FS // 4) % 2 == 0 else 0), (ft - 1) * FS + jl
                xlen = -(-(n + sk * ((n - 1) // FS)) // 4) * 4
            else:  # frame rows of xr, xr / 4 odd
                xlen = ft * (jl + (4 if (jl // 4) % 2 == 0 else 0))
            ring, pw = STAGES * js * 2 * PASS_BINS, ft * pws
            alias = npass == 1 and pw <= ring
            floats = (ring + (0 if alias else pw) + xlen * (2 if precision == "high" else 1)
                      + (jl if unfused else 0) + 2 * nt * -(-FL // 16) * 16 + -(-ft // 4) * 4)
            smem = 4 * floats
            need = smem if need is None else min(need, smem)
            if smem > MAX_SMEM:
                continue
            ctas = B * -(-T // ft)
            per_sm = 1 if (R, WR) == (8, 2) else max(1, min(2, SM_SMEM // (smem + 1024)))
            used = min(per_sm, -(-ctas // sms))
            waves = -(-ctas // (sms * used))
            cost = (waves * used * (ft + CTA_COST_FRAMES), -ft, -js)
            if best is None or cost < best[0]:
                best = (cost, dict(tier=precision, frames_per_thread=R, warp_rows=WR,
                                   frames_per_cta=ft, threads=128 * WR, slab_rows=js,
                                   stages=STAGES, passes=npass,
                                   tail_bins=nt, staging="span" if span else "frames",
                                   power_over_ring=alias, shared_bytes=smem,
                                   blocks_per_sm=used, ctas=ctas, waves=waves))
    if best is None:
        raise ValueError(
            f"log_mel kernel: n_fft {n_fft}, frame_len {FL} need {need} bytes of shared memory "
            f"at the smallest frame tile, above the {MAX_SMEM} bytes a block may use")
    return best[1]


_plan = functools.lru_cache(maxsize=1024)(launch_plan)  # each shape is planned once


def _lib() -> ctypes.CDLL:
    lib = _build.load("log_mel")
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
    head = [P, L, L, L, P, P, P, P, P, I, I, I, I, ctypes.c_float, I, I, I, I, I, L]
    for fn in (lib.uasr_log_mel, lib.uasr_log_mel_unfused):
        fn.argtypes = head + [P, I]
        fn.restype = I
    for fn in (lib.uasr_log_mel_phases, lib.uasr_log_mel_unfused_phases):
        fn.argtypes = head + [P, P, I]
        fn.restype = I
    return lib


def _launch(unfused: bool, audio: torch.Tensor, state: FrontendState, frame_len: int,
            frame_shift: int, n_fft: int, precision: str, want_energy: bool,
            phases: bool = False):
    """Check the operands, plan and launch one of the two kernels of
    log_mel.cu (with ``phases``, its stamped build)."""
    global LAST_PLAN
    consts = (state.window, state.dft_pack) if unfused else (state.pre_pack, state.pre_bvec)
    if state.mel_runs is None or any(c is None for c in consts):
        raise ValueError("log_mel kernel needs a state from make_frontend_state "
                         "(mel runs and packed bases)")
    for t in (audio, *consts, state.mel_w):
        if t.device != audio.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("log_mel kernel takes contiguous float32 tensors on one device")
    runs = state.mel_runs
    if runs.device != audio.device or runs.dtype != torch.int32 or not runs.is_contiguous():
        raise ValueError("log_mel kernel takes contiguous int32 mel runs on the audio's device")
    B, L = audio.shape
    NB = n_fft // 2 + 1
    M = state.mel_fb.shape[1]
    pack = consts[1 if unfused else 0]
    flp = -(-frame_len // 16) * 16
    npass = max(1, -(-(NB - NB % 4) // PASS_BINS))
    if (pack.shape != (npass * flp * 2 * PASS_BINS + 8 * flp,) or state.mel_fb.shape[0] != NB
            or runs.shape != (3, M)):
        raise ValueError("frontend state does not match frame_len / n_fft")
    dev = audio.device
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    plan = _plan(B, L, frame_len, frame_shift, n_fft, precision, unfused,
                 torch.cuda.get_device_properties(index).multi_processor_count, FORCE_TILE)
    T = num_frames_static(L, frame_len, frame_shift)
    out = torch.empty(B, T, M + int(want_energy), device=dev, dtype=torch.float32)
    ph = (torch.zeros(plan["ctas"], len(PHASE_NAMES), dtype=torch.int64, device=dev)
          if phases else None)
    lib = _lib()
    entry = "uasr_log_mel" + ("_unfused" if unfused else "") + ("_phases" if phases else "")
    code = getattr(lib, entry)(
        audio.data_ptr(), B, L, T, *(c.data_ptr() for c in consts), runs.data_ptr(),
        state.mel_w.data_ptr(), out.data_ptr(), frame_len, frame_shift, NB, M, 1.0 / n_fft,
        TIERS[precision], int(want_energy), plan["frames_per_thread"], plan["warp_rows"],
        plan["slab_rows"], plan["shared_bytes"], *((ph.data_ptr(),) if phases else ()),
        torch.cuda.current_stream(dev).cuda_stream, index,
    )
    _build.check(lib, code, "log_mel kernel")
    LAST_PLAN = plan
    return (out, ph) if phases else out


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
    out = _launch(False, audio, state, frame_len, frame_shift, n_fft, precision, want_energy)
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
    out = _launch(True, audio, state, frame_len, frame_shift, n_fft, precision, want_energy)
    LAUNCHES_UNFUSED += 1
    return out


def log_mel_fused_phases(audio, state, frame_len, frame_shift, n_fft, precision="highest",
                         want_energy=False):
    """K1 built with its phase stamps (a diagnostic; no path calls it):
    ``log_mel_fused_cuda``'s output, and [CTAs, len(PHASE_NAMES)] int64
    clock cycles that each CTA's thread 0 spent in each phase."""
    global LAUNCHES_PHASES
    res = _launch(False, audio, state, frame_len, frame_shift, n_fft, precision, want_energy,
                  True)
    LAUNCHES_PHASES += 1
    return res


def log_mel_unfused_phases(audio, state, frame_len, frame_shift, n_fft, precision="highest",
                           want_energy=False):
    """K7 built with its phase stamps, as ``log_mel_fused_phases``."""
    global LAUNCHES_PHASES
    res = _launch(True, audio, state, frame_len, frame_shift, n_fft, precision, want_energy,
                  True)
    LAUNCHES_PHASES += 1
    return res


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
    from uasr_torch.ops import library

    if state.pre_cos is None:
        raise ValueError("fused log-mel needs a state with folded bases (make_frontend_state)")
    return library.log_mel_fused(audio, state.pre_cos, state.pre_sin, state.pre_bvec,
                                 state.mel_fb, state.pre_pack, state.mel_runs, state.mel_w,
                                 cfg.frame_length, cfg.frame_shift, cfg.n_fft, precision,
                                 want_energy)


def log_mel_unfused(
    audio: torch.Tensor,
    state: FrontendState,
    cfg: FrontendConfig,
    precision: str = "highest",
    want_energy: bool = False,
) -> torch.Tensor:
    """[B, L] pre-emphasised audio -> [B, T, M] log-mel ([B, T, M+1] with
    the log total power column when ``want_energy``): the operator
    ``uasr::log_mel_unfused``, K7 for CUDA tensors, the plain version for
    CPU tensors."""
    from uasr_torch.ops import library

    return library.log_mel_unfused(audio, state.window, state.cos_basis, state.sin_basis,
                                   state.mel_fb, state.dft_pack, state.mel_runs, state.mel_w,
                                   cfg.frame_length, cfg.frame_shift, cfg.n_fft, precision,
                                   want_energy)
