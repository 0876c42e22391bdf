"""K4, exact CTC prefix beam search: wrapper of ``csrc/ctc_beam.cu``, its
plain PyTorch version, and the tracebacks that rebuild prefixes.

Counterpart of ``uasr/ops/pallas_beam.py`` (TPU kernel ``_beam_kernel``;
the traceback and compaction of ``ctc_beam_search_decode_pallas``).
``ctc_beam_steps`` launches the kernel for CUDA tensors and runs
``ctc_beam_reference`` for CPU tensors. Both follow the TPU kernel's
semantics exactly: W*V extends then W stays per step, hash-fold of the
one possible duplicate, top-W by W rounds of (max, lowest-index argmax),
hashes wrapping mod 2^32, per-slot sentinels for dead beams, frozen
finished utterances. ``ctc_beam_phases`` runs the kernel's build with
phase stamps (``uasr_torch.tools.time_beam`` reads them); ``LAST_BEAM_PLAN``
is the last launch's plan (warps per CTA, CTAs per utterance).

Both take the beam state to start from and return the state after the
last step (``BeamState``; a fresh one is ``beam_init``), so a decode fed
in chunks, each from the state the previous chunk left, gives the same
bits as one pass: the streaming beam of ``uasr_torch.serve`` (the JAX
package's ``ctc_beam_scan`` carried in ``_BeamState``).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from uasr_torch import _build

LAUNCHES = 0  # kernel launches by ctc_beam_cuda (read by chip_smoke.py)
LAUNCHES_PHASES = 0  # launches of the stamped build by ctc_beam_phases
LAST_BEAM_PLAN = None  # (warps per CTA, CTAs per utterance) of the last launch
# the phases ctc_beam_phases stamps, in the order of its columns
PHASE_NAMES = ("row", "stays", "candidates", "merge", "rebuild", "barriers")

NEG = -1e30
_HASH_MULT = 2654435761  # Knuth multiplicative hash
_HASH2_MULT = 40503
_SENT1 = 0xC0000000  # dead-slot sentinel bases (-0x40000000, -0x20000000
_SENT2 = 0xE0000000  # as 32-bit patterns)
_M32 = 0xFFFFFFFF
# the kernel's limits: one register list of up to 32 beams per thread, and
# 12 V bytes of shared memory (two log-prob rows and a fold mark per symbol)
MAX_BEAM = 32
MAX_VOCAB = 16384


class BeamState(NamedTuple):
    """Carried prefix-beam state (``uasr.ops.decode._BeamState``), [B, W]
    each; the hashes are int32 tensors holding the uint32 bit patterns."""

    last: torch.Tensor  # last symbol, -1 if empty
    last2: torch.Tensor  # second-to-last symbol (trigram LM history)
    hash1: torch.Tensor
    hash2: torch.Tensor
    p_b: torch.Tensor  # log prob of the prefix ending in blank
    p_nb: torch.Tensor  # ending in non-blank


def beam_init(batch: int, beam_width: int, device="cpu") -> BeamState:
    """Fresh state: one live beam, the empty prefix with p_b = 1
    (``ctc_beam_init``)."""
    B, W = batch, beam_width
    full = lambda v, dt: torch.full((B, W), v, dtype=dt, device=device)  # noqa: E731
    p_b = full(NEG, torch.float32)
    p_b[:, 0] = 0.0
    return BeamState(full(-1, torch.int32), full(-1, torch.int32), full(0, torch.int32),
                     full(0, torch.int32), p_b, full(NEG, torch.float32))


def _u32(h: torch.Tensor) -> torch.Tensor:
    return h.long() & _M32


def _i32(h: torch.Tensor) -> torch.Tensor:
    return torch.where(h >= 2 ** 31, h - 2 ** 32, h).to(torch.int32)


def _logaddexp(a, b):
    m = torch.maximum(a, b)
    m_safe = torch.clamp(m, min=NEG)
    return torch.where(m <= NEG, NEG,
                       m_safe + torch.log1p(torch.exp(torch.minimum(a, b) - m_safe)))


def _hash_mul(h: torch.Tensor, mult: int) -> torch.Tensor:
    """(h * mult) mod 2^32 for int64 h in [0, 2^32), in 16-bit halves so no
    int64 product overflows."""
    lo, hi = h & 0xFFFF, h >> 16
    return (lo * mult + (((hi * mult) & 0xFFFF) << 16)) & _M32


def ctc_beam_reference(logp, lengths, beam_width: int, blank_id: int = 0,
                       lm_table=None, lm_order: int = 0, lm_weight: float = 1.0,
                       lm_bonus: float = 0.0, state: BeamState | None = None):
    """Plain version of K4, vectorised over the batch.

    logp [B, T, V] f32 log-softmax, lengths [B]; lm_table [H, V] f32
    (bigram H = V+1, trigram H = (V+1)^2 with row hist2 * (V+1) + hist)
    when lm_order is 2 or 3; ``state`` to start from (``beam_init`` if
    None). Returns parents, chars [T, B, W] int32 and the state after the
    last step.
    """
    B, T, V = logp.shape
    W = beam_width
    WV, K = W * V, W * V + W
    dev = logp.device
    if state is None:
        state = beam_init(B, W, dev)
    lengths = lengths.to(dev)
    sym = torch.arange(V, device=dev)
    w_idx = torch.arange(W, device=dev)[None, :]
    k_idx = torch.arange(K, device=dev)[None, :]
    earlier = w_idx.T < w_idx  # [W'(src wp), W'(dst wp)]: src before dst
    last, last2 = state.last.long(), state.last2.long()
    h1, h2 = _u32(state.hash1), _u32(state.hash2)
    pb, pnb = state.p_b.float(), state.p_nb.float()
    parents = torch.empty(T, B, W, dtype=torch.int32, device=dev)
    chars = torch.empty(T, B, W, dtype=torch.int32, device=dev)
    for t in range(T):
        lp = logp[:, t]  # [B, V]
        tot = _logaddexp(pb, pnb)
        st_pb = tot + lp[:, blank_id : blank_id + 1]
        st_pnb = torch.where(last >= 0, pnb + lp.gather(1, last.clamp(min=0)), NEG)
        ext = torch.where(sym[None, None, :] == last[..., None], pb[..., None],
                          tot[..., None]) + lp[:, None, :]  # [B, W, V]
        if lm_order:
            hist = torch.where(last >= 0, last, V)
            if lm_order == 3:
                hist = hist + torch.where(last2 >= 0, last2, V) * (V + 1)
            ext = ext + lm_weight * lm_table[hist]
            ext = ext + lm_bonus
        ext = torch.where(sym == blank_id, NEG, ext)
        # fold: ext(w, c = last[wp]) matches stay(wp); the kernel visits wp
        # in order and NEGs a folded entry, so an entry folds into the
        # first matching wp only
        cp = last.clamp(min=0)
        match = (
            (last[:, None, :] >= 0)
            & (((_hash_mul(h1, _HASH_MULT)[:, :, None] + cp[:, None, :] + 1) & _M32)
               == h1[:, None, :])
            & (((_hash_mul(h2, _HASH2_MULT)[:, :, None] + cp[:, None, :] + 7) & _M32)
               == h2[:, None, :])
        )  # [B, W(src w), W'(wp)]
        same_c = (last[:, :, None] == last[:, None, :]) & earlier  # [B, W', W']
        taken = torch.bmm(match.float(), same_c.float()) > 0
        g = ext.gather(2, cp[:, None, :].expand(B, W, W))  # ext[b, w, last[wp]]
        contrib = torch.where(match & ~taken, g, NEG)
        fold = contrib[:, 0]
        for w in range(1, W):
            fold = _logaddexp(fold, contrib[:, w])
        st_pnb = _logaddexp(st_pnb, fold)
        folded = torch.bmm(match.float(), torch.nn.functional.one_hot(cp, V).float()) > 0
        ext = torch.where(folded, NEG, ext).reshape(B, WV)
        # top-W: W rounds of (max, lowest-index argmax, mask)
        cand = torch.cat([ext, _logaddexp(st_pb, st_pnb)], 1)
        cols = []
        for _ in range(W):
            mx = cand.max(1, keepdim=True).values
            col = torch.where(cand == mx, k_idx, K).min(1, keepdim=True).values
            cols.append(col)
            cand = cand.scatter(1, col, NEG)
        col = torch.cat(cols, 1)  # [B, W]
        is_ext = col < WV
        parent = torch.where(is_ext, col // V, col - WV)
        ch = torch.where(is_ext, col % V, -1)
        p_last, p_last2 = last.gather(1, parent), last2.gather(1, parent)
        p_h1, p_h2 = h1.gather(1, parent), h2.gather(1, parent)
        s_pb = torch.where(is_ext, NEG, st_pb.gather(1, parent))
        s_pnb = torch.where(is_ext, ext.gather(1, col.clamp(max=WV - 1)),
                            st_pnb.gather(1, parent))
        s_h1 = torch.where(is_ext, (_hash_mul(p_h1, _HASH_MULT) + ch + 1) & _M32, p_h1)
        s_h2 = torch.where(is_ext, (_hash_mul(p_h2, _HASH2_MULT) + ch + 7) & _M32, p_h2)
        dead = _logaddexp(s_pb, s_pnb) < 0.5 * NEG
        s_h1 = torch.where(dead, _SENT1 + w_idx, s_h1)
        s_h2 = torch.where(dead, _SENT2 + w_idx, s_h2)
        active = (t < lengths)[:, None]
        last = torch.where(active, torch.where(is_ext, ch, p_last), last)
        last2 = torch.where(active, torch.where(is_ext, p_last, p_last2), last2)
        h1 = torch.where(active, s_h1, h1)
        h2 = torch.where(active, s_h2, h2)
        pb = torch.where(active, s_pb, pb)
        pnb = torch.where(active, s_pnb, pnb)
        parents[t] = torch.where(active, parent, w_idx)
        chars[t] = torch.where(active, ch, -1)
    new = BeamState(last.to(torch.int32), last2.to(torch.int32), _i32(h1), _i32(h2),
                    pb.contiguous(), pnb)
    return parents, chars, new


def _lib() -> ctypes.CDLL:
    lib = _build.load("ctc_beam")
    P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.uasr_ctc_beam.argtypes = [P, P, P, I, Fl, Fl, I, I, I, I, I, P, P, P, P, P, P, P, I]
    lib.uasr_ctc_beam.restype = I
    lib.uasr_ctc_beam_phases.argtypes = [P, P, P, I, Fl, Fl, I, I, I, I, I, P, P, P, P, P, P, P,
                                         P, I]
    lib.uasr_ctc_beam_phases.restype = I
    lib.uasr_ctc_beam_plan.argtypes = [I, I, P, P]
    lib.uasr_ctc_beam_plan.restype = None
    return lib


def beam_plan(lib, beam_width: int, vocab: int) -> tuple[int, int]:
    """The kernel's launch plan: (warps per CTA, CTAs per utterance)."""
    warps, ctas = ctypes.c_int(), ctypes.c_int()
    lib.uasr_ctc_beam_plan(beam_width, vocab, ctypes.byref(warps), ctypes.byref(ctas))
    return warps.value, ctas.value


def ctc_beam_cuda(logp, lengths, beam_width: int, blank_id: int = 0, lm_table=None,
                  lm_order: int = 0, lm_weight: float = 1.0, lm_bonus: float = 0.0,
                  state: BeamState | None = None):
    """Launch K4 on CUDA tensors; same contract as the plain version."""
    global LAUNCHES
    out = _launch(logp, lengths, beam_width, blank_id, lm_table, lm_order, lm_weight, lm_bonus,
                  state, None)
    LAUNCHES += 1
    return out


def ctc_beam_phases(logp, lengths, beam_width: int, blank_id: int = 0, lm_table=None,
                    lm_order: int = 0, lm_weight: float = 1.0, lm_bonus: float = 0.0,
                    state: BeamState | None = None):
    """K4 built with its phase stamps (a diagnostic; no decode path calls
    it): ``ctc_beam_cuda``'s outputs, and [B, len(PHASE_NAMES)] int64
    clock cycles that the CTA's thread 0 spent in each phase, summed over
    the utterance's steps (``uasr_torch.tools.time_beam`` reads them)."""
    global LAUNCHES_PHASES
    phases = torch.zeros(logp.shape[0], len(PHASE_NAMES), dtype=torch.int64, device=logp.device)
    out = _launch(logp, lengths, beam_width, blank_id, lm_table, lm_order, lm_weight, lm_bonus,
                  state, phases)
    LAUNCHES_PHASES += 1
    return (*out, phases)


def _launch(logp, lengths, beam_width, blank_id, lm_table, lm_order, lm_weight, lm_bonus,
            state, phases):
    global LAST_BEAM_PLAN
    B, T, V = logp.shape
    W = beam_width
    if not 1 <= W <= MAX_BEAM:
        raise ValueError(f"beam kernel takes 1 <= beam_width <= {MAX_BEAM}, got {W}")
    if not 1 <= V <= MAX_VOCAB:
        raise ValueError(f"beam kernel takes a vocabulary of 1..{MAX_VOCAB} symbols, got {V}")
    if logp.dtype != torch.float32 or not logp.is_contiguous():
        raise ValueError("beam kernel takes contiguous float32 log-probs")
    if not 0 <= blank_id < V:
        raise ValueError(f"blank_id {blank_id} outside the vocabulary of {V}")
    if (lm_table is None) != (lm_order == 0):
        raise ValueError("lm_table and lm_order must be given together")
    if lm_table is not None and (lm_table.dtype != torch.float32 or not lm_table.is_contiguous()
                                 or lm_table.device != logp.device):
        raise ValueError("beam kernel takes a contiguous float32 LM table on the logits' device")
    dev = logp.device
    if state is None:
        state = beam_init(B, W, dev)
    istate = torch.stack([state.last, state.last2, state.hash1, state.hash2]).to(
        device=dev, dtype=torch.int32).contiguous()
    fstate = torch.stack([state.p_b, state.p_nb]).to(device=dev, dtype=torch.float32).contiguous()
    if istate.shape != (4, B, W):
        raise ValueError(f"beam state of shape {tuple(istate.shape[1:])}, expected {(B, W)}")
    lens = lengths.to(device=dev, dtype=torch.int32).contiguous()
    parents = torch.empty(T, B, W, dtype=torch.int32, device=dev)
    chars = torch.empty(T, B, W, dtype=torch.int32, device=dev)
    istate_out = torch.empty_like(istate)
    fstate_out = torch.empty_like(fstate)
    lib = _lib()
    args = (logp.data_ptr(), lens.data_ptr(), None if lm_table is None else lm_table.data_ptr(),
            lm_order, float(lm_weight), float(lm_bonus), T, B, V, W, blank_id,
            istate.data_ptr(), fstate.data_ptr(), parents.data_ptr(), chars.data_ptr(),
            istate_out.data_ptr(), fstate_out.data_ptr())
    tail = (torch.cuda.current_stream(dev).cuda_stream,
            dev.index if dev.index is not None else torch.cuda.current_device())
    if phases is None:
        code = lib.uasr_ctc_beam(*args, *tail)
    else:
        code = lib.uasr_ctc_beam_phases(*args, phases.data_ptr(), *tail)
    _build.check(lib, code, "ctc_beam kernel")
    LAST_BEAM_PLAN = beam_plan(lib, W, V)
    return parents, chars, BeamState(*istate_out.unbind(0), *fstate_out.unbind(0))


def ctc_beam_steps(logp, lengths, beam_width: int, blank_id: int = 0, lm_table=None,
                   lm_order: int = 0, lm_weight: float = 1.0, lm_bonus: float = 0.0,
                   state: BeamState | None = None):
    """The beam recursion from ``state`` (fresh if None): K4 for CUDA
    tensors, the plain version for CPU tensors. Returns (parents, chars
    [T, B, W], the state after the last step). The recursion is the
    operator ``uasr::ctc_beam`` (``ops/library.py``)."""
    from uasr_torch.ops import library

    if state is None:
        state = beam_init(logp.shape[0], beam_width, logp.device)
    parents, chars, *new = library.ctc_beam(logp, lengths, lm_table, *state, beam_width,
                                            blank_id, lm_order, float(lm_weight),
                                            float(lm_bonus))
    return parents, chars, BeamState(*new)


def compact_left(values: torch.Tensor, keep: torch.Tensor, fill: int) -> torch.Tensor:
    """Left-align values[b, t] where keep[b, t], padding with ``fill``."""
    B, T = values.shape
    pos = torch.where(keep, torch.cumsum(keep, 1) - 1, T)  # dropped -> column T
    out = torch.full((B, T + 1), fill, dtype=values.dtype, device=values.device)
    return out.scatter(1, pos, values)[:, :T]


def ancestor_maps(parents: torch.Tensor) -> torch.Tensor:
    """[T, B, W]: entry [t, b, w] is the beam after step t that beam w of
    the last step descends from.

    The map at step t composes the parent maps of the steps after it;
    pointer doubling builds every suffix composition in ceil(log2 T)
    batched gathers instead of a T-step loop, with the same integers as
    walking back one step at a time."""
    T, B, W = parents.shape
    ident = torch.arange(W, device=parents.device).expand(1, B, W)
    maps = torch.cat([parents[1:].long(), ident], 0)  # one-step maps
    d = 1
    while d < T:
        maps = torch.cat([maps[:-d].gather(2, maps[d:]), maps[-d:]], 0)
        d *= 2
    return maps


def beam_traceback(parents, chars, pb, pnb, blank_id: int = 0):
    """Rebuild the best prefix from the backpointers: (ids [B, T] padded
    with blank_id, lengths [B], best log-prob [B])."""
    T, B, W = parents.shape
    total = _logaddexp(pb, pnb)
    best = total.argmax(1)  # first maximum, as jnp.argmax
    idx = ancestor_maps(parents).gather(2, best[None, :, None].expand(T, B, 1))  # [T, B, 1]
    path = chars.gather(2, idx)[..., 0].T.long()  # [B, T]; -1 = no char
    keep = path >= 0
    ids = compact_left(torch.clamp(path, min=0), keep, blank_id)
    return ids, keep.sum(1), total.gather(1, best[:, None])[:, 0]
