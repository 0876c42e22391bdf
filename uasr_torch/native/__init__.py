"""ctypes bindings of the native host runtime (counterpart of
``uasr.native``): ``batch_read_wavs_native``, the streaming loader's
parallel PCM16 decode into a zero-padded batch, and
``batch_edit_distance_native``, batched Levenshtein on the host.

The library (``uasr_native.cpp``) is compiled with ``g++`` at the first
call by ``uasr_torch._build.load_host``, never at import. A failed build
raises with the compiler's messages: unlike the JAX package's binding,
nothing falls back to a Python reader or scorer. Their plain versions are
``uasr_torch.data.io.read_wav`` and
``uasr_torch.ops.edit_distance.batch_edit_distance``.
"""

from __future__ import annotations

import ctypes

import numpy as np

_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)
_F32P = ctypes.POINTER(ctypes.c_float)


def load() -> ctypes.CDLL:
    """The native library, built at the first call, with every entry
    point's signature declared."""
    from uasr_torch import _build

    lib = _build.load_host("uasr_native")
    lib.batch_edit_distance.argtypes = [_I32P, _I32P, _I32P, _I32P, ctypes.c_int32,
                                        ctypes.c_int32, ctypes.c_int32, _I32P, ctypes.c_int32]
    lib.batch_edit_distance.restype = None
    lib.batch_read_wavs.argtypes = [ctypes.c_char_p, _I64P, ctypes.c_int32, _F32P,
                                    ctypes.c_int64, _I64P, _I32P, ctypes.c_int32]
    lib.batch_read_wavs.restype = None
    lib.read_wav_pcm16.argtypes = [ctypes.c_char_p, _F32P, ctypes.c_int64, _I32P]
    lib.read_wav_pcm16.restype = ctypes.c_int64
    return lib


def _ptr(a: np.ndarray, kind):
    return a.ctypes.data_as(kind)


def batch_edit_distance_native(
    refs: np.ndarray, ref_lens: np.ndarray, hyps: np.ndarray, hyp_lens: np.ndarray,
    num_threads: int = 0,
) -> np.ndarray:
    """Levenshtein distance per pair, on host threads (0 = one per core).
    refs [B, N], hyps [B, M] integer; lengths [B] within the padded widths."""
    refs = np.ascontiguousarray(refs, np.int32)
    hyps = np.ascontiguousarray(hyps, np.int32)
    ref_lens = np.ascontiguousarray(ref_lens, np.int32)
    hyp_lens = np.ascontiguousarray(hyp_lens, np.int32)
    if refs.ndim != 2 or hyps.ndim != 2 or len(hyps) != len(refs):
        raise ValueError(f"refs {refs.shape} and hyps {hyps.shape}: expected [B, N] and [B, M]")
    B, N = refs.shape
    M = hyps.shape[1]
    if ref_lens.shape != (B,) or hyp_lens.shape != (B,):
        raise ValueError(f"lengths {ref_lens.shape}, {hyp_lens.shape}: expected ({B},)")
    if B and (ref_lens.min() < 0 or ref_lens.max() > N or hyp_lens.min() < 0
              or hyp_lens.max() > M):
        raise ValueError(f"lengths outside [0, {N}] / [0, {M}]")
    out = np.zeros(B, np.int32)
    load().batch_edit_distance(_ptr(refs, _I32P), _ptr(ref_lens, _I32P), _ptr(hyps, _I32P),
                               _ptr(hyp_lens, _I32P), B, N, M, _ptr(out, _I32P), num_threads)
    return out


def batch_read_wavs_native(
    paths: list[str], max_samples: int, num_threads: int = 0,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Decode PCM16 WAVs on host threads (0 = one per core) into a
    zero-padded [B, max_samples] float32 batch, channels averaged, each
    file truncated to ``max_samples``. Returns (audio, lengths,
    sample_rates); length -1 marks a file that could not be decoded
    (missing, truncated, not RIFF/WAVE or not PCM16)."""
    B = len(paths)
    out = np.zeros((B, max_samples), np.float32)
    lengths = np.zeros(B, np.int64)
    rates = np.zeros(B, np.int32)
    encoded = [p.encode() for p in paths]
    blob = b"".join(p + b"\0" for p in encoded)
    offsets = np.zeros(B, np.int64)
    if B > 1:
        offsets[1:] = np.cumsum([len(p) + 1 for p in encoded[:-1]])
    load().batch_read_wavs(blob, _ptr(offsets, _I64P), B, _ptr(out, _F32P), max_samples,
                           _ptr(lengths, _I64P), _ptr(rates, _I32P), num_threads)
    return out, lengths, rates
