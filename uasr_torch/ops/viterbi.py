"""HMM Viterbi decoding and CTC forced alignment on the logits' device
(counterpart of ``uasr.ops.viterbi``).

Two lattices, as in the JAX package:

- ``lm_hmm`` + ``viterbi_decode`` (``viterbi_lm_decode``): free decoding
  over a CTC-topology HMM (phone states, per-phone blank holds, one
  initial blank) whose phone -> phone transitions are a bigram LM table;
  ``trigram_hmm`` + ``viterbi_trigram_decode``: the same over phone-pair
  histories for a trigram table, contracted over the one predecessor slot
  each step. ``make_lm_decoder`` picks one by the table's rank.
- ``ctc_forced_align``: Viterbi over the 2L+1 CTC label lattice, the best
  monotonic alignment of a known transcript (``uasr_torch.tools.align``).

The JAX package runs these as ``lax.scan`` max-plus recursions outside any
Pallas kernel, so here they are plain PyTorch loops over time on whatever
device the logits are on. Every step keeps JAX's order of operations
(delta + transition, then the max, then + emission), first-maximum
argmaxes (``torch.argmax``) and its strict comparisons, so states and ids
are the JAX package's bit for bit on the same log-probabilities. The
backpointers are walked back on the device one step at a time.

The table builders (``lm_hmm``, ``trigram_hmm``) and the rate
calibration (``estimate_hmm_rates``) are the JAX package's numpy bodies.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from uasr_torch.ops.cuda_beam import compact_left

NEG = -1e30


def _log_softmax(logits: torch.Tensor) -> torch.Tensor:
    return torch.log_softmax(logits.float(), dim=-1)


# ---------------------------------------------------------------------------
# generic dense-transition Viterbi
# ---------------------------------------------------------------------------


def viterbi_decode(emit_logp: torch.Tensor, lengths: torch.Tensor, log_init: torch.Tensor,
                   log_trans: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Max-plus Viterbi over a dense-transition HMM.

    emit_logp [B, T, S] per-frame state emission log-probs, lengths [B]
    valid frame counts, log_init [S], log_trans [S, S] (log P(j | i) at
    [i, j]). Returns (states [B, T] int64 best path, score [B]); rows t >=
    lengths[b] repeat the final state."""
    B, T, S = emit_logp.shape
    dev = emit_logp.device
    lengths = lengths.to(dev)
    ident = torch.arange(S, device=dev)[None, :].expand(B, S)
    delta = log_init[None, :] + emit_logp[:, 0, :]
    bps = []
    for t in range(1, T):
        scores = delta[:, :, None] + log_trans[None, :, :]  # [B, S(from), S(to)]
        bp = torch.argmax(scores, dim=1)
        new = scores.amax(dim=1) + emit_logp[:, t, :]
        active = (t < lengths)[:, None]
        delta = torch.where(active, new, delta)
        bps.append(torch.where(active, bp, ident))
    best = torch.argmax(delta, dim=1)
    score = delta.amax(dim=1)
    states = [best]
    for bp in reversed(bps):  # bps[k] holds step k + 1
        states.append(bp.gather(1, states[-1][:, None])[:, 0])
    return torch.stack(states[::-1], dim=1), score


# ---------------------------------------------------------------------------
# CTC-topology HMM with bigram-LM transitions
# ---------------------------------------------------------------------------


def lm_hmm(lm_logp: np.ndarray, blank_id: int, self_loop: float = 0.75,
           blank_prob: float = 0.1) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Build the CTC-topology HMM from a bigram LM table.

    lm_logp: [V + 1, V] table (row V = start-of-sequence; the blank
    COLUMN carries ~0 mass).

    States (S = 2V + 1):
      s in [0, V):   emitting phone s           (dead for s == blank_id)
      s in [V, 2V):  blank hold after phone s-V (dead for blank phone)
      s == 2V:       initial blank (start-of-sequence LM history)

    Transitions (probability space, rows renormalized over live states):
      phone i:  self_loop -> i | blank_prob -> blank_i
                | rest * P_lm(j | i) -> phone j != i
      blank_i:  self_loop -> blank_i | rest * P_lm(j | i) -> any phone j
                (j == i re-enters as a NEW token — CTC semantics)
      init blank: self_loop hold | rest * P_lm(j | SOS)

    Returns (log_init [S], log_trans [S, S], emit_cols [S] int32) with
    emit_cols mapping each state to the logits column it consumes.
    """
    V = lm_logp.shape[1]
    if lm_logp.ndim != 2 or lm_logp.shape[0] != V + 1:
        raise ValueError(
            f"lm_hmm needs a bigram [V+1, V] table, got {lm_logp.shape}"
        )
    S = 2 * V + 1
    P = np.exp(lm_logp.astype(np.float64))  # [V+1, V]
    live = np.ones(V, bool)
    live[blank_id] = False
    # renormalize LM rows over live phone columns
    P = P * live[None, :]
    P = P / np.maximum(P.sum(axis=1, keepdims=True), 1e-30)

    trans = np.zeros((S, S), np.float64)
    for i in range(V):
        if not live[i]:
            continue
        # phone -> phone (exclude self: the self-loop carries that mass)
        row = P[i].copy()
        denom = row.sum() - row[i]
        rest = max(1.0 - self_loop - blank_prob, 1e-6)
        if denom > 1e-30:
            trans[i, :V] = rest * row / denom
            trans[i, i] = 0.0
        trans[i, i] = self_loop
        trans[i, V + i] = blank_prob
        # blank_i -> phones (all live, LM history = i) / hold
        trans[V + i, :V] = (1.0 - self_loop) * P[i]
        trans[V + i, V + i] = self_loop
    # initial blank: SOS history
    trans[2 * V, :V] = (1.0 - self_loop) * P[V]
    trans[2 * V, 2 * V] = self_loop

    init = np.zeros(S, np.float64)
    init[:V] = 0.5 * P[V]
    init[2 * V] = 0.5

    with np.errstate(divide="ignore"):
        log_trans = np.where(trans > 0, np.log(trans), NEG)
        log_init = np.where(init > 0, np.log(init), NEG)

    emit_cols = np.concatenate(
        [np.arange(V), np.full(V + 1, blank_id)]
    ).astype(np.int32)
    return (
        log_init.astype(np.float32),
        log_trans.astype(np.float32),
        emit_cols,
    )


def greedy_path_stats(logits: torch.Tensor, lengths: torch.Tensor,
                      blank_id: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Greedy-argmax path statistics for ``estimate_hmm_rates``:
    (valid_steps, blank_steps, tokens) summed over the batch, where
    ``tokens`` counts collapsed non-blank runs."""
    B, T = logits.shape[:2]
    am = torch.argmax(logits, dim=-1)
    valid = torch.arange(T, device=logits.device)[None, :] < lengths.to(logits.device)[:, None]
    blank = (am == blank_id) & valid
    prev = F.pad(am, (1, 0), value=-1)[:, :T]
    tok = (am != blank_id) & (am != prev) & valid
    return valid.sum(), blank.sum(), tok.sum()


def estimate_hmm_rates(valid_steps: int, blank_steps: int, tokens: int) -> tuple[float, float]:
    """Calibrate ``lm_hmm``'s dwell prior to the stream being decoded.

    self_loop ≈ 1 - 1/dwell with dwell = non-blank steps per emitted
    token: a frame-level 33 Hz stream with ~4-frame phones gives ~0.75
    (the default), while a merged SEGMENT-level stream (a
    ``gan.merge_repeats`` generator) has dwell ≈ 1 → self_loop ≈ 0, so the
    transition prior does not out-vote the emissions and merge adjacent
    segments. blank_prob scales with the observed blank fraction of the
    greedy path (floored so repeated phones stay expressible via the
    blank-hold state)."""
    valid_steps = max(int(valid_steps), 1)
    nonblank = max(valid_steps - int(blank_steps), 1)
    dwell = nonblank / max(int(tokens), 1)
    self_loop = float(np.clip(1.0 - 1.0 / max(dwell, 1.0), 0.0, 0.95))
    blank_frac = int(blank_steps) / valid_steps
    blank_prob = float(
        np.clip(blank_frac * (1.0 - self_loop), 0.01, 0.4)
    )
    return self_loop, blank_prob


def resolve_viterbi_rates(ctc_cfg, probe_logits, probe_batches,
                          max_batches: int = 4) -> tuple[float, float, str]:
    """Resolve the HMM dwell rates for a decode run.

    ``ctc.viterbi_auto_rates`` calibrates only when the rates were LEFT at
    ``CTCConfig``'s defaults (explicitly tuned rates are kept), averaging
    ``greedy_path_stats`` over up to ``max_batches`` probe batches.
    ``probe_logits(batch) -> (logits, out_lengths)`` runs the model being
    decoded. Returns (self_loop, blank_prob, provenance for a log line)."""
    from uasr_torch.config import CTCConfig

    sl, bp = ctc_cfg.viterbi_self_loop, ctc_cfg.viterbi_blank_prob
    if not ctc_cfg.viterbi_auto_rates:
        return sl, bp, "explicit (viterbi_auto_rates off)"
    defaults = (CTCConfig.viterbi_self_loop, CTCConfig.viterbi_blank_prob)
    if (sl, bp) != defaults:
        return sl, bp, (
            "explicit rates kept (viterbi_self_loop/viterbi_blank_prob "
            "differ from defaults; auto-calibration skipped)"
        )
    totals = np.zeros(3, np.int64)
    n = 0
    for b in probe_batches:
        logits, out_len = probe_logits(b)
        totals += np.array(
            [int(x) for x in greedy_path_stats(logits, out_len, ctc_cfg.blank_id)], np.int64)
        n += 1
        if n >= max_batches:
            break
    if n == 0:
        return sl, bp, "defaults (no probe batches available)"
    sl, bp = estimate_hmm_rates(*totals)
    return sl, bp, f"calibrated over {n} probe batch(es)"


def viterbi_lm_decode(logits: torch.Tensor, lengths: torch.Tensor, hmm: tuple,
                      blank_id: int = 0) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """LM-smoothed HMM decode of frame/segment logits; ``hmm`` = (log_init,
    log_trans, emit_cols) from ``lm_hmm`` as tensors on the logits' device.
    Returns (ids [B, T] left-compacted, out_lengths [B], score [B])."""
    log_init, log_trans, emit_cols = hmm
    V = logits.shape[-1]
    emit = _log_softmax(logits).index_select(2, emit_cols)  # [B, T, S]
    states, score = viterbi_decode(emit, lengths, log_init, log_trans)
    ids, out_len = states_to_tokens(states, lengths, V, blank_id)
    return ids, out_len, score


def states_to_tokens(states: torch.Tensor, lengths: torch.Tensor, vocab_size: int,
                     blank_id: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Collapse an HMM state path to token ids: a token is emitted on
    entry into a phone state (s < V) from a different state. Returns (ids
    [B, T] left-compacted padded with blank_id, out_lengths [B])."""
    B, T = states.shape
    valid = torch.arange(T, device=states.device)[None, :] < lengths.to(states.device)[:, None]
    prev = F.pad(states, (1, 0), value=-1)[:, :T]
    keep = (states < vocab_size) & (states != prev) & valid
    return compact_left(states, keep, blank_id), keep.sum(1)


# ---------------------------------------------------------------------------
# trigram CTC-topology HMM (structured (prev, cur) phone-pair lattice)
# ---------------------------------------------------------------------------


def trigram_hmm(lm3: np.ndarray, blank_id: int, self_loop: float = 0.75,
                blank_prob: float = 0.1, device="cpu") -> dict:
    """Log-coefficient tensors for ``viterbi_trigram_decode``, on ``device``.

    lm3: [V+1, V+1, V] trigram table (history index V = start-of-sequence).
    States are phone-pair histories (a, b), per-pair blank holds and one
    initial blank; each Viterbi step contracts only over the predecessor
    slot ``a`` ([B, H, V, V] work instead of a dense [B, S, S] with S =
    O(V^2)).
    """
    Vp1, Vp1b, V = lm3.shape
    if Vp1 != V + 1 or Vp1b != V + 1:
        raise ValueError(
            f"trigram_hmm needs a [V+1, V+1, V] table, got {lm3.shape}"
        )
    H = V + 1
    P = np.exp(lm3.astype(np.float64))  # [H, H, V]
    live = np.ones(V, bool)
    live[blank_id] = False
    P = P * live[None, None, :]
    P = P / np.maximum(P.sum(axis=2, keepdims=True), 1e-30)

    rest = max(1.0 - self_loop - blank_prob, 1e-6)
    # advance P(a, b) -> P(b, c), c != b: log(rest * P(c|a,b)) with the
    # self column's mass renormalized away (the self-loop carries it)
    Pb = P[:, :V, :].copy()  # histories with a real current phone b
    b_idx = np.arange(V)
    self_col = Pb[:, b_idx, b_idx]  # [H, V]
    denom = np.maximum(Pb.sum(axis=2) - self_col, 1e-30)  # [H, V]
    adv = Pb / denom[:, :, None]
    adv[:, b_idx, b_idx] = 0.0
    with np.errstate(divide="ignore"):
        log_adv = np.where(adv > 0, np.log(rest * adv), NEG)
        # blank exit B(a, b) -> P(b, c), any live c (repeat re-entry)
        log_exit = np.where(
            Pb > 0, np.log(max(1.0 - self_loop, 1e-6) * Pb), NEG
        )
        # initial blank -> P(SOS, c)
        log_init_c = np.where(
            P[V, V] > 0,
            np.log(max(1.0 - self_loop, 1e-6) * P[V, V]), NEG,
        )
        # t=0: P(SOS, c) with prob 0.5 * P(c|SOS,SOS), I with 0.5
        log_start_c = np.where(
            P[V, V] > 0, np.log(0.5 * P[V, V]), NEG
        )

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    return {
        "V": V,
        "blank_id": blank_id,
        "log_adv": f32(log_adv),  # [H, V, V]
        "log_exit": f32(log_exit),  # [H, V, V]
        "log_init_c": f32(log_init_c),  # [V]
        "log_start_c": f32(log_start_c),  # [V]
        "log_sl": f32(np.log(max(self_loop, 1e-30))),
        "log_bp": f32(np.log(max(blank_prob, 1e-30))),
        "log_start_i": f32(np.log(0.5)),
        "live": torch.as_tensor(live, device=device),
    }


def viterbi_trigram_decode(logits: torch.Tensor, lengths: torch.Tensor, hmm3: dict,
                           blank_id: int = 0) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Trigram-LM-smoothed HMM decode (the contract of
    ``viterbi_lm_decode``): (ids [B, T] left-compacted, out_lengths [B],
    path score [B]).

    State = (kind, a, b): kind 0 = emitting phone b with previous phone a
    (a = V: start of sequence), kind 1 = blank hold after the pair (a, b),
    kind 2 = the initial blank. The loop carries delta_P / delta_B [B, H,
    V] and delta_I [B]; a P state's backpointer packs src_a * 4 + code
    (code 0 stay, 1 advance from P, 2 exit from B, 3 from the initial
    blank), a B state's is 1 where it was entered from P."""
    B, T, Vl = logits.shape
    V = hmm3["V"]
    if Vl != V:
        raise ValueError(f"logits V={Vl} != table V={V}")
    H = V + 1
    dev = logits.device
    lengths = lengths.to(dev)
    logp = _log_softmax(logits)
    emit_blank = logp[:, :, blank_id]  # [B, T]
    log_adv, log_exit = hmm3["log_adv"], hmm3["log_exit"]
    log_sl, log_bp = hmm3["log_sl"], hmm3["log_bp"]
    live = hmm3["live"]
    is_sos = (torch.arange(H, device=dev) == V)[None, :, None]
    zero_row = torch.zeros(B, 1, V, dtype=torch.long, device=dev)  # the SOS row's

    # ---- t = 0
    dP = torch.full((B, H, V), NEG, device=dev)
    dP[:, V, :] = hmm3["log_start_c"][None, :] + logp[:, 0, :]
    dB = torch.full((B, H, V), NEG, device=dev)
    dI = hmm3["log_start_i"] + emit_blank[:, 0]
    bpPs, bpBs = [], []
    for t in range(1, T):
        e_tok, e_blk = logp[:, t, :], emit_blank[:, t]
        # entry into P(b, c) (new history (b, c)), contracted over a
        x = dP[:, :, :, None] + log_adv[None]  # [B, H(a), V(b), V(c)]
        fromP, argP = x.amax(dim=1), torch.argmax(x, dim=1)
        x = dB[:, :, :, None] + log_exit[None]
        fromB, argB = x.amax(dim=1), torch.argmax(x, dim=1)
        stay = dP + log_sl
        which = fromB > fromP  # the first maximum of (P, B): B only when larger
        ent = torch.cat([torch.maximum(fromP, fromB),
                         (dI[:, None] + hmm3["log_init_c"][None, :])[:, None, :]], dim=1)
        newP = torch.maximum(stay, ent)
        is_entry = ent > stay
        which_h = torch.cat([which.long(), zero_row], dim=1)
        code = torch.where(is_entry, torch.where(is_sos, 3, 1 + which_h), 0)
        src_a = torch.where(code == 1, torch.cat([argP, zero_row], dim=1),
                            torch.where(code == 2, torch.cat([argB, zero_row], dim=1), 0))
        newP = newP + e_tok[:, None, :]
        newP = torch.where(live[None, None, :], newP, NEG)
        # blank holds
        stayB = dB + log_sl
        toB = dP + log_bp
        newB = torch.maximum(stayB, toB) + e_blk[:, None, None]
        codeB = (toB > stayB).to(torch.int32)
        newI = dI + log_sl + e_blk
        bpP = (src_a * 4 + code).to(torch.int32)
        active = (t < lengths)[:, None, None]
        dP = torch.where(active, newP, dP)
        dB = torch.where(active, newB, dB)
        dI = torch.where(active[:, 0, 0], newI, dI)
        bpPs.append(torch.where(active, bpP, 0))
        bpBs.append(torch.where(active, codeB, 0))

    # ---- final state
    HV = H * V
    allf = torch.cat([dP.reshape(B, HV), dB.reshape(B, HV), dI[:, None]], dim=1)
    best = torch.argmax(allf, dim=1)
    score = allf.amax(dim=1)
    kind = torch.where(best < HV, 0, torch.where(best < 2 * HV, 1, 2))
    idx = torch.where(kind < 2, best % HV, 0)
    a, b = idx // V, idx % V

    toks, entered = [], []
    for bpP_t, bpB_t in zip(reversed(bpPs), reversed(bpBs)):
        flat = (a * V + b)[:, None]
        pp = bpP_t.reshape(B, HV).gather(1, flat)[:, 0].long()
        pb = bpB_t.reshape(B, HV).gather(1, flat)[:, 0]
        codeP, src = pp % 4, pp // 4
        # P-state transitions
        pk = torch.where(codeP == 3, 2, torch.where(codeP == 2, 1, 0))
        pa = torch.where(codeP == 0, a, src)
        pb_ = torch.where(codeP == 0, b, a)
        # entry flag: a token was emitted AT this step
        entered.append((kind == 0) & (codeP != 0))
        toks.append(torch.where(kind == 0, b, -1))
        # B-state transitions: 0 stay-B, 1 from-P (same (a, b))
        bk = torch.where(pb == 1, 0, 1)
        kind, a, b = (torch.where(kind == 0, pk, torch.where(kind == 1, bk, 2)),
                      torch.where(kind == 0, pa, torch.where(kind == 1, a, 0)),
                      torch.where(kind == 0, pb_, torch.where(kind == 1, b, 0)))
    toks.append(torch.where(kind == 0, b, -1))
    entered.append(kind == 0)
    toks = torch.stack(toks[::-1], dim=1)  # [B, T]
    entered = torch.stack(entered[::-1], dim=1)
    valid = torch.arange(T, device=dev)[None, :] < lengths[:, None]
    keep = entered & (toks >= 0) & valid
    return compact_left(toks, keep, blank_id), keep.sum(1), score


def make_lm_decoder(table: np.ndarray, blank_id: int, self_loop: float = 0.75,
                    blank_prob: float = 0.1, device="cpu"):
    """``decode(logits, lengths) -> (ids, out_len, score)`` for a BIGRAM
    [V+1, V] or TRIGRAM [V+1, V+1, V] table, its HMM built once and held
    on ``device`` (the logits' device)."""
    if table.ndim == 2:
        log_init, log_trans, emit_cols = lm_hmm(table, blank_id, self_loop=self_loop,
                                                blank_prob=blank_prob)
        hmm = (torch.as_tensor(log_init, device=device), torch.as_tensor(log_trans, device=device),
               torch.as_tensor(emit_cols, dtype=torch.long, device=device))
        return lambda logits, lengths: viterbi_lm_decode(logits, lengths, hmm, blank_id)
    if table.ndim == 3:
        hmm3 = trigram_hmm(table, blank_id, self_loop=self_loop, blank_prob=blank_prob,
                           device=device)
        return lambda logits, lengths: viterbi_trigram_decode(logits, lengths, hmm3, blank_id)
    raise ValueError(f"LM table rank {table.ndim} unsupported")


# ---------------------------------------------------------------------------
# CTC forced alignment (Viterbi over the 2L+1 label lattice)
# ---------------------------------------------------------------------------


def ctc_forced_align(logits: torch.Tensor, lengths: torch.Tensor, labels: torch.Tensor,
                     label_lengths: torch.Tensor,
                     blank_id: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Best CTC alignment of known transcripts: per-frame label ids.

    logits [B, T, V] raw logits; labels [B, L] token ids (no blanks).
    Returns (frame_ids [B, T] int64: blank_id or the aligned label at each
    frame, blank_id at t >= lengths[b]; score [B], the log prob of the best
    path). A zero-length transcript aligns to all blanks. The lattice is
    the CTC loss's: S = 2L + 1 states, even = blank, odd s =
    labels[(s-1)//2]; stay / advance / skip, skip only between distinct
    labels across a blank."""
    B, T, V = logits.shape
    L = labels.shape[1]
    S = 2 * L + 1
    dev = logits.device
    lengths = lengths.to(dev)
    labels = labels.to(dev).long()
    label_lengths = label_lengths.to(dev)
    logp = _log_softmax(logits)

    s_idx = torch.arange(S, device=dev)
    is_lab = (s_idx % 2) == 1
    lab_pos = torch.clamp((s_idx - 1) // 2, 0, L - 1)
    # state -> emitted token column
    state_tok = torch.where(is_lab[None, :],
                            labels.gather(1, (lab_pos[None, :] % L).expand(B, S)), blank_id)
    # dead states beyond this utterance's transcript
    alive = s_idx[None, :] < (2 * label_lengths[:, None] + 1)
    # skip (s-2 -> s) only into a label state whose label differs from
    # the previous label state's
    prev_lab = labels.gather(1, (torch.clamp(lab_pos[None, :] - 1, min=0) % L).expand(B, S))
    can_skip = is_lab[None, :] & (lab_pos[None, :] >= 1) & (state_tok != prev_lab)

    emit = logp.gather(2, state_tok[:, None, :].expand(B, T, S))  # [B, T, S]
    start_ok = (s_idx[None, :] <= 1) & alive
    delta = torch.where(start_ok, emit[:, 0], NEG)
    ident = torch.zeros(B, S, dtype=torch.long, device=dev)  # backpointer = shift amount

    def shift(x, k):
        return F.pad(x, (k, 0), value=NEG)[:, :S]

    bps = []
    for t in range(1, T):
        skp = torch.where(can_skip, shift(delta, 2), NEG)
        stacked = torch.stack([delta, shift(delta, 1), skp], dim=0)  # [3, B, S]
        bp = torch.argmax(stacked, dim=0)
        new = torch.where(alive, stacked.amax(dim=0) + emit[:, t], NEG)
        active = (t < lengths)[:, None]
        delta = torch.where(active, new, delta)
        bps.append(torch.where(active, bp, ident))

    # final state: best of last blank (2*l) and last label (2*l - 1)
    end_b = 2 * label_lengths
    end_l = torch.clamp(2 * label_lengths - 1, min=0)
    d_endb = delta.gather(1, end_b[:, None])[:, 0]
    d_endl = delta.gather(1, end_l[:, None])[:, 0]
    state = torch.where(d_endl > d_endb, end_l, end_b)
    score = torch.maximum(d_endb, d_endl)
    states = [state]
    for bp in reversed(bps):
        state = state - bp.gather(1, state[:, None])[:, 0]
        states.append(state)
    states = torch.stack(states[::-1], dim=1)
    frame_ids = state_tok.gather(1, states)
    live_t = torch.arange(T, device=dev)[None, :] < lengths[:, None]
    frame_ids = torch.where(live_t, frame_ids, blank_id)
    # zero-length transcripts: the lattice is the single blank state
    frame_ids = torch.where((label_lengths == 0)[:, None] & live_t, blank_id, frame_ids)
    return frame_ids, score
