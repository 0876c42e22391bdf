"""Exact CTC prefix beam search, batched over utterances.

Each beam holds a prefix with its blank-ending and non-blank-ending
log-probabilities. A frame's candidates: every beam kept (blank, or its
last symbol repeated), and every beam extended by each non-blank symbol
(from the blank-ending mass alone when the symbol repeats the last one).
An extension that spells a prefix already in the beam is folded into that
beam. The W candidates of highest total probability survive; a frame past
an utterance's length changes nothing. Prefixes are compared through two
polynomial hashes of the token sequence.
"""

from __future__ import annotations

import torch

P1, M1 = 1_000_003, 2_147_483_647
P2, M2 = 998_244_353 % 2_147_483_629, 2_147_483_629
NEG = float("-inf")


def _key(h1, h2):
    return h1 * M2 + h2


def prefix_beam(logp: torch.Tensor, lengths: torch.Tensor, width: int,
                blank: int = 0) -> list[list[int]]:
    """logp [B, T, V] log-probabilities -> the best prefix of each row."""
    B, T, V = logp.shape
    W, dev = width, logp.device
    bidx = torch.arange(B, device=dev)[:, None]
    p_b = torch.full((B, W), NEG, device=dev)
    p_b[:, 0] = 0.0
    p_nb = torch.full((B, W), NEG, device=dev)
    h1 = torch.zeros(B, W, dtype=torch.long, device=dev)
    h2 = torch.zeros(B, W, dtype=torch.long, device=dev)
    # dead beams get keys no prefix can have
    h2[:, 1:] = -torch.arange(1, W, device=dev)
    par1, par2 = h1.clone(), h2.clone()
    plen = torch.zeros(B, W, dtype=torch.long, device=dev)
    last = torch.full((B, W), -1, dtype=torch.long, device=dev)
    seqs = torch.zeros(B, W, T, dtype=torch.long, device=dev)
    sym = torch.arange(V, device=dev)
    for t in range(T):
        lp = logp[:, t]  # [B, V]
        live = (t < lengths)[:, None]
        tot = torch.logaddexp(p_b, p_nb)
        # kept prefixes
        s_b = tot + lp[:, blank][:, None]
        rep = lp.gather(1, last.clamp(min=0))
        s_nb = torch.where(last >= 0, p_nb + rep, NEG)
        # extensions [B, W, V]
        base = torch.where(sym[None, None, :] == last[..., None], p_b[..., None], tot[..., None])
        ext = base + lp[:, None, :]
        ext[:, :, blank] = NEG
        e1 = (h1[..., None] * P1 + sym + 1) % M1
        e2 = (h2[..., None] * P2 + sym + 1) % M2
        # fold: beam j's prefix = beam i's prefix + last[j]
        match = (_key(par1, par2)[:, :, None] == _key(h1, h2)[:, None, :]) & (plen[:, :, None]
                                                                             == plen[:, None, :] + 1)
        match &= (plen > 0)[:, :, None]
        into = ext.gather(2, last.clamp(min=0)[:, None, :].expand(B, W, W)).transpose(1, 2)
        folded = torch.where(match, into, NEG).logsumexp(2)  # [B, W] mass into beam j
        s_nb = torch.logaddexp(s_nb, folded)
        # an extension that was folded is not a candidate of its own
        hit = torch.zeros(B, W, V, dtype=torch.bool, device=dev)
        src = match.float().argmax(2)  # parent beam i of j, where matched
        any_m = match.any(2)
        hit[bidx.expand(B, W)[any_m], src[any_m], last.clamp(min=0)[any_m]] = True
        ext = torch.where(hit, NEG, ext)
        cand = torch.cat([torch.logaddexp(s_b, s_nb), ext.reshape(B, W * V)], 1)
        top = cand.topk(W, 1).indices  # [B, W]
        is_ext = top >= W
        parent = torch.where(is_ext, (top - W) // V, top)
        c = torch.where(is_ext, (top - W) % V, -1)
        g = lambda x: x.gather(1, parent)  # noqa: E731
        n_pb = torch.where(is_ext, NEG, s_b.gather(1, parent))
        n_pnb = torch.where(is_ext, cand.gather(1, top), s_nb.gather(1, parent))
        n_h1 = torch.where(is_ext, e1.reshape(B, -1).gather(1, top.clamp(min=W) - W), g(h1))
        n_h2 = torch.where(is_ext, e2.reshape(B, -1).gather(1, top.clamp(min=W) - W), g(h2))
        n_seq = seqs.gather(1, parent[..., None].expand(B, W, T)).clone()
        n_len = g(plen)
        pos = n_len.clamp(max=T - 1)
        n_seq.scatter_(2, pos[..., None], torch.where(is_ext, c, n_seq.gather(2, pos[..., None])
                                                      [..., 0])[..., None])
        n_par1 = torch.where(is_ext, g(h1), g(par1))
        n_par2 = torch.where(is_ext, g(h2), g(par2))
        n_last = torch.where(is_ext, c, g(last))
        n_len = n_len + is_ext.long()
        # dead candidates get unmatchable keys and fold nothing
        dead = ~torch.isfinite(torch.logaddexp(n_pb, n_pnb))
        n_h2 = torch.where(dead, -1 - torch.arange(W, device=dev)[None, :], n_h2)
        n_par2 = torch.where(dead, -1 - W - torch.arange(W, device=dev)[None, :], n_par2)
        n_len = torch.where(dead, 0, n_len)
        upd = lambda new, old: torch.where(live, new, old)  # noqa: E731
        p_b, p_nb = upd(n_pb, p_b), upd(n_pnb, p_nb)
        h1, h2, par1, par2 = upd(n_h1, h1), upd(n_h2, h2), upd(n_par1, par1), upd(n_par2, par2)
        last, plen = upd(n_last, last), upd(n_len, plen)
        seqs = torch.where(live[..., None], n_seq, seqs)
    best = torch.logaddexp(p_b, p_nb).argmax(1)
    out = []
    for b in range(B):
        j = int(best[b])
        out.append(seqs[b, j, :int(plen[b, j])].tolist())
    return out
