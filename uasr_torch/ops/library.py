"""The port's forward kernels as PyTorch operators, namespace ``uasr``.

Each operator is registered with ``torch.library.custom_op``: its CUDA
implementation calls the kernel's wrapper (so the wrapper's launch
counter counts it), its CPU implementation the kernel's plain version,
and its fake implementation gives the outputs' shapes and dtypes without
running anything. The dispatcher picks the implementation from the
device of the operator's tensors: CUDA tensors launch the kernel or
raise, CPU tensors run the plain version; nothing gives way to the plain
version on a CUDA tensor.

The eager dispatch functions (``cuda_frontend.log_mel_fused`` and
``log_mel_unfused``, ``cuda_gru.bigru_scan`` and ``gru_scan``,
``cuda_attention.attn_core``, ``cuda_beam.ctc_beam_steps``) and the
forwards of ``BiGRUScan``, ``GRUScan`` and ``MHSAttention`` call these
operators, so an eager run and a ``torch.export`` program
(``uasr_torch.tools.export``) take the same route. An exported program
holds them as ``torch.ops.uasr.*`` nodes: a serving process imports this
module to register them before ``torch.export.load``, and the kernels are
built at their first launch.

| operator | kernel | wrapper |
|---|---|---|
| ``uasr::log_mel_fused`` | K1 | ``cuda_frontend.log_mel_fused_cuda`` |
| ``uasr::log_mel_unfused`` | K7 | ``cuda_frontend.log_mel_unfused_cuda`` |
| ``uasr::bigru_scan`` | K2 | ``cuda_gru.bigru_scan_cuda`` |
| ``uasr::gru_scan`` | K5 | ``cuda_gru.gru_scan_cuda`` |
| ``uasr::mhsa_fwd`` | K6 | ``cuda_attention.mhsa_fwd_cuda`` |
| ``uasr::ctc_beam`` | K4 | ``cuda_beam.ctc_beam_cuda`` |

Structures are passed as their tensors: the frontend state's bases, the
beam state's six [B, W] tensors, an optional LM table.
"""

from __future__ import annotations

import torch
from torch import Tensor
from torch.library import custom_op

from uasr_torch.frontend import cuda_frontend as cf
from uasr_torch.frontend.features import FrontendState, num_frames_static
from uasr_torch.models import cuda_gru as cg
from uasr_torch.ops import cuda_attention as ca
from uasr_torch.ops import cuda_beam as cb

OPERATORS = ("log_mel_fused", "log_mel_unfused", "bigru_scan", "gru_scan", "mhsa_fwd",
             "ctc_beam")


def _own(outs, ins):
    """``outs`` with every tensor that shares storage with one of ``ins``
    copied: an operator's outputs may not alias its inputs."""
    ptrs = {t.untyped_storage().data_ptr() for t in ins if isinstance(t, Tensor)}
    return tuple(o.clone() if o.untyped_storage().data_ptr() in ptrs else o for o in outs)


# ---------------------------------------------------------------- K1, K7


def _fused_state(pre_cos, pre_sin, pre_bvec, mel_fb, pre_pack, mel_runs, mel_w):
    return FrontendState(None, None, None, mel_fb, None, None, None, None, pre_cos=pre_cos,
                         pre_sin=pre_sin, pre_bvec=pre_bvec, mel_runs=mel_runs, mel_w=mel_w,
                         pre_pack=pre_pack)


def _unfused_state(window, cos_basis, sin_basis, mel_fb, dft_pack, mel_runs, mel_w):
    return FrontendState(window, cos_basis, sin_basis, mel_fb, None, None, None, None,
                         mel_runs=mel_runs, mel_w=mel_w, dft_pack=dft_pack)


@custom_op("uasr::log_mel_fused", mutates_args=(), device_types="cuda")
def log_mel_fused(audio: Tensor, pre_cos: Tensor, pre_sin: Tensor, pre_bvec: Tensor,
                  mel_fb: Tensor, pre_pack: Tensor, mel_runs: Tensor, mel_w: Tensor,
                  frame_len: int, frame_shift: int, n_fft: int, precision: str,
                  want_energy: bool) -> Tensor:
    """K1: [B, L] raw audio -> [B, T, M (+1)] log-mel."""
    st = _fused_state(pre_cos, pre_sin, pre_bvec, mel_fb, pre_pack, mel_runs, mel_w)
    return cf.log_mel_fused_cuda(audio, st, frame_len, frame_shift, n_fft, precision,
                                 want_energy)


@log_mel_fused.register_kernel("cpu")
def _(audio, pre_cos, pre_sin, pre_bvec, mel_fb, pre_pack, mel_runs, mel_w, frame_len,
      frame_shift, n_fft, precision, want_energy):
    st = _fused_state(pre_cos, pre_sin, pre_bvec, mel_fb, pre_pack, mel_runs, mel_w)
    return cf.log_mel_fused_reference(audio, st, frame_len, frame_shift, n_fft, precision,
                                      want_energy)


def _log_mel_fake(audio, mel_fb, frame_len, frame_shift, want_energy):
    B, L = audio.shape
    T = num_frames_static(L, frame_len, frame_shift)
    return audio.new_empty(B, T, mel_fb.shape[1] + int(want_energy))


@log_mel_fused.register_fake
def _(audio, pre_cos, pre_sin, pre_bvec, mel_fb, pre_pack, mel_runs, mel_w, frame_len,
      frame_shift, n_fft, precision, want_energy):
    return _log_mel_fake(audio, mel_fb, frame_len, frame_shift, want_energy)


@custom_op("uasr::log_mel_unfused", mutates_args=(), device_types="cuda")
def log_mel_unfused(audio: Tensor, window: Tensor, cos_basis: Tensor, sin_basis: Tensor,
                    mel_fb: Tensor, dft_pack: Tensor, mel_runs: Tensor, mel_w: Tensor,
                    frame_len: int, frame_shift: int, n_fft: int, precision: str,
                    want_energy: bool) -> Tensor:
    """K7: [B, L] pre-emphasised audio -> [B, T, M (+1)] log-mel."""
    st = _unfused_state(window, cos_basis, sin_basis, mel_fb, dft_pack, mel_runs, mel_w)
    return cf.log_mel_unfused_cuda(audio, st, frame_len, frame_shift, n_fft, precision,
                                   want_energy)


@log_mel_unfused.register_kernel("cpu")
def _(audio, window, cos_basis, sin_basis, mel_fb, dft_pack, mel_runs, mel_w, frame_len,
      frame_shift, n_fft, precision, want_energy):
    st = _unfused_state(window, cos_basis, sin_basis, mel_fb, dft_pack, mel_runs, mel_w)
    return cf.log_mel_unfused_reference(audio, st, frame_len, frame_shift, n_fft, precision,
                                        want_energy)


@log_mel_unfused.register_fake
def _(audio, window, cos_basis, sin_basis, mel_fb, dft_pack, mel_runs, mel_w, frame_len,
      frame_shift, n_fft, precision, want_energy):
    return _log_mel_fake(audio, mel_fb, frame_len, frame_shift, want_energy)


# ---------------------------------------------------------------- K2, K5


@custom_op("uasr::bigru_scan", mutates_args=(), device_types="cuda")
def bigru_scan(p0: Tensor, p1: Tensor, wh: Tensor, bh: Tensor, tmask: Tensor) -> Tensor:
    """K2: both directions' recurrence, [T, B, 3H] x 2 -> [T, B, 2H]."""
    return cg.bigru_scan_cuda(p0, p1, wh, bh, tmask)


@bigru_scan.register_kernel("cpu")
def _(p0, p1, wh, bh, tmask):
    return cg.bigru_scan_reference(p0, p1, wh, bh, tmask)


@bigru_scan.register_fake
def _(p0, p1, wh, bh, tmask):
    T, B, H3 = p0.shape
    return p0.new_empty(T, B, 2 * (H3 // 3))


@custom_op("uasr::gru_scan", mutates_args=(), device_types="cuda")
def gru_scan(xproj: Tensor, wh: Tensor, bh: Tensor, tmask: Tensor,
             save_coeffs: bool) -> tuple[Tensor, Tensor, Tensor]:
    """K5: G recurrences, [T, G, B, 3H] -> (ys [T, G, B, H], c4, ch); c4
    and ch are the backward's coefficients with ``save_coeffs``, else
    empty."""
    out = cg.gru_scan_cuda(xproj, wh, bh, tmask, save_coeffs)
    return out if save_coeffs else (out, *_no_coeffs(xproj))


@gru_scan.register_kernel("cpu")
def _(xproj, wh, bh, tmask, save_coeffs):
    out = cg.gru_scan_reference(xproj, wh, bh, tmask, save_coeffs)
    return out if save_coeffs else (out, *_no_coeffs(xproj))


def _no_coeffs(xproj):
    return xproj.new_empty(0), xproj.new_empty(0, dtype=torch.float32)


@gru_scan.register_fake
def _(xproj, wh, bh, tmask, save_coeffs):
    T, G, B, H3 = xproj.shape
    H = H3 // 3
    if not save_coeffs:
        return xproj.new_empty(T, G, B, H), *_no_coeffs(xproj)
    return (xproj.new_empty(T, G, B, H), xproj.new_empty(T, G, B, 4 * H),
            xproj.new_empty(T, G, B, H, dtype=torch.float32))


# ---------------------------------------------------------------- K6


@custom_op("uasr::mhsa_fwd", mutates_args=(), device_types="cuda")
def mhsa_fwd(q: Tensor, k: Tensor, v: Tensor, bias: Tensor | None, kmask: Tensor,
             num_heads: int) -> tuple[Tensor, Tensor]:
    """K6: padded self-attention [B, Tp, H * dh] -> (out, lse [B, H, Tp])."""
    return ca.mhsa_fwd_cuda(q, k, v, bias, kmask, num_heads)


@mhsa_fwd.register_kernel("cpu")
def _(q, k, v, bias, kmask, num_heads):
    return ca.mhsa_fwd_reference(q, k, v, bias, kmask, num_heads)


@mhsa_fwd.register_fake
def _(q, k, v, bias, kmask, num_heads):
    B, Tp, _ = q.shape
    return q.new_empty(q.shape), q.new_empty(B, num_heads, Tp, dtype=torch.float32)


# ---------------------------------------------------------------- K4


@custom_op("uasr::ctc_beam", mutates_args=(), device_types="cuda")
def ctc_beam(logp: Tensor, lengths: Tensor, lm_table: Tensor | None, last: Tensor,
             last2: Tensor, hash1: Tensor, hash2: Tensor, p_b: Tensor, p_nb: Tensor,
             beam_width: int, blank_id: int, lm_order: int, lm_weight: float,
             lm_bonus: float) -> tuple[Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor,
                                       Tensor]:
    """K4 from the beam state (last, last2, hash1, hash2 int32, p_b, p_nb
    f32, [B, W] each): (parents, chars [T, B, W] int32, the six state
    tensors after the last step)."""
    state = cb.BeamState(last, last2, hash1, hash2, p_b, p_nb)
    parents, chars, new = cb.ctc_beam_cuda(logp, lengths, beam_width, blank_id, lm_table,
                                           lm_order, lm_weight, lm_bonus, state)
    # the wrapper's six state tensors are views of two: outputs may not alias
    return parents, chars, *(t.clone() for t in new)


@ctc_beam.register_kernel("cpu")
def _(logp, lengths, lm_table, last, last2, hash1, hash2, p_b, p_nb, beam_width, blank_id,
      lm_order, lm_weight, lm_bonus):
    state = cb.BeamState(last, last2, hash1, hash2, p_b, p_nb)
    parents, chars, new = cb.ctc_beam_reference(logp, lengths, beam_width, blank_id, lm_table,
                                                lm_order, lm_weight, lm_bonus, state)
    return _own((parents, chars, *(t.to(s.dtype) for t, s in zip(new, state))),
                (logp, lengths, *state))


@ctc_beam.register_fake
def _(logp, lengths, lm_table, last, last2, hash1, hash2, p_b, p_nb, beam_width, blank_id,
      lm_order, lm_weight, lm_bonus):
    B, T, _ = logp.shape
    W = beam_width
    i32 = torch.int32
    return (logp.new_empty(T, B, W, dtype=i32), logp.new_empty(T, B, W, dtype=i32),
            *(logp.new_empty(B, W, dtype=i32) for _ in range(4)),
            logp.new_empty(B, W), logp.new_empty(B, W))
