"""Inference / decode entry (counterpart of ``uasr.infer``, ``--mode infer``).

Decodes batches on one device (greedy, exact prefix beam search with
optional shallow n-gram fusion, or HMM Viterbi over an n-gram table) and
reports PER/CER plus decode RTF (each request's time from its upload to
its readback, over audio seconds), and with ``fold_timit`` the PER in
TIMIT's folded 39-phone space, scored on the host by the native edit
distance.
On CUDA the frontend, the BiGRU recurrence and the beam recursion go
through kernels K1, K2 and K4 when ``frontend.use_pallas``,
``model.gru_pallas`` and ``ctc.use_beam`` are set; ``ctc.lm_path`` hands
K4 a bigram or trigram table, loaded onto the device once per run.
``ctc.use_viterbi`` decodes with ``ops.viterbi.make_lm_decoder`` over the
``ctc.lm_path`` table (plain PyTorch on the logits' device, as the JAX
package runs it outside any kernel), its dwell rates calibrated on the
first four batches' greedy paths (``resolve_viterbi_rates``; those
batches' forward is run once more, outside the timed wall). A GAN or
EODM generator decodes through ``logits_fn`` (``train.GeneratorInfer``:
the frontend, segmentation, classifier and repeat merge it trained on),
which replaces the frontend and the model, for the probe as for the
decode.

Over a mesh (``mesh``; one process per device under torchrun) each batch
is split over the data group: a ragged batch is zero-padded to a multiple
of the data size (zero-length rows decode to nothing and score nothing),
each rank runs the frontend (K1), the encoder and the decode (K4, greedy
or Viterbi) on its rows, the error and reference counts are summed over
the group, and rank 0 gathers the hypotheses and writes them. The rate
probe of ``ctc.use_viterbi`` runs whole batches on every rank.
"""

from __future__ import annotations

import itertools
import time
from typing import Iterable

import numpy as np
import torch

from uasr_torch import profiling, resolve_device
from uasr_torch.config import Config
from uasr_torch.data.dataset import Batch
from uasr_torch.frontend.features import FrontendState, compute_features
from uasr_torch.ops.decode import ctc_beam_search_decode, ctc_greedy_decode
from uasr_torch.ops.edit_distance import batch_edit_distance
from uasr_torch.ops.lm import load_decode_table
from uasr_torch.parallel.collectives import _all_gather
from uasr_torch.parallel.mesh import Mesh, shard_batch
from uasr_torch.train import _audio_seconds, _global_counts, _to_device, pad_rows
from uasr_torch.vocab import Vocab

# which beam recursion the last run_inference ran: "cuda" (K4) or
# "reference" (its plain version, CPU tensors), with "_sharded" when the
# batches were split over a mesh's data group; None for greedy
LAST_BEAM_IMPL: str | None = None


def _gather_hyps(hyps: torch.Tensor, hyp_len: torch.Tensor, mesh: Mesh):
    """Every rank's (hyps, lengths) concatenated in data-rank order; the
    hypotheses padded with zeros to the widest rank's."""
    w = torch.tensor([hyps.shape[1]], device=hyps.device)
    torch.distributed.all_reduce(w, op=torch.distributed.ReduceOp.MAX, group=mesh.data_group)
    hyps = torch.nn.functional.pad(hyps, (0, int(w) - hyps.shape[1]))
    return (_all_gather(hyps, 0, mesh.data_group),
            _all_gather(hyp_len.to(hyps.dtype), 0, mesh.data_group))


def _logits(cfg: Config, model, fstate: FrontendState, audio, alen, logits_fn=None):
    if logits_fn is not None:
        return logits_fn(audio, alen)
    if audio.ndim == 3:  # precomputed features: frontend bypassed
        feats, flen = audio, alen
    else:
        with profiling.span("infer.frontend"):
            feats, flen = compute_features(audio, alen, fstate, cfg.frontend)
    with profiling.span("infer.encoder"):
        return model(feats, flen)


def _decode_batch(cfg: Config, model, fstate: FrontendState, db: list[torch.Tensor],
                  logits_fn=None, lm_table=None, viterbi_fn=None):
    global LAST_BEAM_IMPL
    audio, alen, labels, llen = db
    logits, out_len = _logits(cfg, model, fstate, audio, alen, logits_fn)
    if viterbi_fn is not None:
        hyps, hyp_len, _ = viterbi_fn(logits, out_len)
    elif cfg.ctc.use_beam:
        with profiling.span("infer.beam"):
            hyps, hyp_len, _ = ctc_beam_search_decode(
                logits, out_len, cfg.ctc.beam_width, cfg.ctc.blank_id, lm_logp=lm_table,
                lm_weight=cfg.ctc.lm_weight, lm_bonus=cfg.ctc.lm_bonus)
        LAST_BEAM_IMPL = "cuda" if logits.is_cuda else "reference"
    else:
        hyps, hyp_len = ctc_greedy_decode(logits, out_len, cfg.ctc.blank_id)
    with profiling.span("infer.score"):
        dist = batch_edit_distance(labels, llen, hyps, hyp_len)
        # zero-length rows (batch padding) score nothing
        pad_row = alen == 0
        dist = torch.where(pad_row, 0, dist)
        hyp_len = torch.where(pad_row, 0, hyp_len)
        return hyps, hyp_len, dist.sum(), llen.sum()


def _write_hyps(vocab: Vocab, hyps, hyp_len, b, hyp_f, fold_timit: bool, n_utts: int,
                fold_pairs: list) -> int:
    """Decode a batch's hypotheses to tokens, write them to ``hyp_f`` (if
    open) and, with ``fold_timit``, append (reference, hypothesis) token
    pairs; returns the utterances written so far."""
    labels, label_len = (x.cpu().numpy() if isinstance(x, torch.Tensor)
                         else np.asarray(x) for x in b[2:4])
    for i in range(hyps.shape[0]):
        toks = vocab.decode_for_scoring(hyps[i, : int(hyp_len[i])], fold_timit=fold_timit)
        if hyp_f is not None:
            hyp_f.write(f"utt{n_utts}\t{' '.join(toks)}\n")
        n_utts += 1
        if fold_timit:
            ref = vocab.decode_for_scoring(labels[i, : int(label_len[i])], fold_timit=True)
            fold_pairs.append((ref, toks))
    return n_utts


def run_inference(
    cfg: Config,
    model: torch.nn.Module,
    frontend_state: FrontendState | None,
    batches: Iterable[Batch],
    vocab: Vocab | None = None,
    hyp_path: str | None = None,
    device="cuda",
    logits_fn=None,
    fold_timit: bool = False,
    mesh: Mesh | None = None,
) -> dict:
    """Decode + score. Returns {"per", "rtf", "audio_seconds", "errors",
    "ref_tokens"}, and "per_folded" with ``fold_timit`` and a ``vocab``:
    references and hypotheses folded 61 -> 39 (``Vocab.decode_for_scoring``),
    the hypothesis file written in folded tokens. Runs on ``device``
    (default CUDA; raises when no card is present rather than running on
    the CPU). ``logits_fn(audio, lengths) -> (logits, lengths)``, when
    given, computes the logits in place of ``model`` over
    ``compute_features``. Batches of [B, T, D] features bypass the
    frontend (``frontend_state`` may then be None), and the RTF's audio
    seconds count their frames by ``frontend.frame_shift_ms``. Over
    ``mesh`` every rank passes the same batches and gets the same result;
    rank 0 writes ``hyp_path``."""
    global LAST_BEAM_IMPL
    LAST_BEAM_IMPL = None
    device = resolve_device(device)
    dp = 1 if mesh is None else mesh.data_size
    model = model.to(device).eval()
    fstate = frontend_state.to(device) if frontend_state is not None else None
    V = cfg.dim_output
    viterbi_fn = lm_table = None
    if cfg.ctc.use_viterbi:
        from uasr_torch.ops.viterbi import make_lm_decoder, resolve_viterbi_rates

        if not cfg.ctc.lm_path:
            raise ValueError(
                "ctc.use_viterbi needs ctc.lm_path (a bigram/trigram "
                "table from `prepare lm`) for the HMM transitions"
            )
        table = load_decode_table(cfg.ctc.lm_path, V, lambda shape: (
            f"ctc.use_viterbi needs a [{V + 1}, {V}] bigram or "
            f"[{V + 1}, {V + 1}, {V}] trigram table, got {shape}"))
        # dwell calibration on the first batches' greedy paths, through the
        # same forward as the decode; they are decoded again below
        batches = iter(batches)
        probe = list(itertools.islice(batches, 4))
        batches = itertools.chain(probe, batches)

        def probe_fn(b):
            audio, alen = _to_device(b[:2], device)
            with torch.inference_mode():
                return _logits(cfg, model, fstate, audio, alen, logits_fn)

        sl, bp, _how = resolve_viterbi_rates(cfg.ctc, probe_fn, probe)
        viterbi_fn = make_lm_decoder(table, cfg.ctc.blank_id, self_loop=sl, blank_prob=bp,
                                     device=device)
    if cfg.ctc.use_beam and cfg.ctc.lm_path:
        table = load_decode_table(cfg.ctc.lm_path, V, lambda shape: (
            f"ctc.lm_path table shape {shape} does not match the model vocabulary "
            f"([{V + 1}, {V}] bigram or [{V + 1}, {V + 1}, {V}] trigram expected)"))
        lm_table = torch.as_tensor(table, device=device)
    errs = total = 0
    audio_sec = 0.0
    wall = 0.0
    n_utts = 0
    fold_pairs: list[tuple[list[str], list[str]]] = []
    writes = mesh is None or mesh.is_writer
    hyp_f = open(hyp_path, "w") if hyp_path and writes else None
    try:
        for b in batches:
            with profiling.span("infer.request"):
                B0 = len(b[0])
                rows = b[:4] if dp == 1 else shard_batch(pad_rows(b[:4], dp), mesh)
                # the request's time: from the upload to the readback, which
                # fences the device's work
                t0 = time.perf_counter()
                with profiling.span("infer.upload"):
                    db = _to_device(rows, device)
                with torch.inference_mode():
                    hyps, hyp_len, e, t = _decode_batch(cfg, model, fstate, db, logits_fn,
                                                        lm_table, viterbi_fn)
                    if dp > 1:
                        hyps, hyp_len = (x[:B0] for x in _gather_hyps(hyps, hyp_len, mesh))
                        if LAST_BEAM_IMPL is not None:
                            LAST_BEAM_IMPL += "_sharded"
                with profiling.span("infer.readback"):
                    hyps, hyp_len = hyps.cpu().numpy(), hyp_len.cpu().numpy()
                    e, t = int(e), int(t)
                wall += time.perf_counter() - t0
                audio_sec += _audio_seconds(cfg, b)
                errs += e
                total += t
                if vocab is not None and (hyp_f is not None or fold_timit):
                    with profiling.span("infer.write"):
                        n_utts = _write_hyps(vocab, hyps, hyp_len, b, hyp_f, fold_timit,
                                             n_utts, fold_pairs)
    finally:
        if hyp_f is not None:
            hyp_f.close()
    errs, total = _global_counts(mesh, errs, total)
    out = {
        "per": errs / max(total, 1),
        "rtf": wall / max(audio_sec, 1e-9),
        "audio_seconds": audio_sec,
        "errors": errs,
        "ref_tokens": total,
    }
    if fold_pairs:
        out["per_folded"] = folded_per(fold_pairs)
    return out


def folded_per(pairs: list[tuple[list[str], list[str]]]) -> float:
    """Edit distance over reference tokens of (reference, hypothesis)
    token lists, the tokens numbered in sorted order, by the native
    edit distance on the host."""
    from uasr_torch.native import batch_edit_distance_native

    sym = {t: i for i, t in enumerate(sorted({t for r, h in pairs for t in r + h}))}
    N = max(max(len(r) for r, _ in pairs), 1)
    M = max(max(len(h) for _, h in pairs), 1)
    refs = np.zeros((len(pairs), N), np.int32)
    hyps = np.zeros((len(pairs), M), np.int32)
    rl = np.zeros(len(pairs), np.int32)
    hl = np.zeros(len(pairs), np.int32)
    for i, (r, h) in enumerate(pairs):
        refs[i, : len(r)] = [sym[t] for t in r]
        hyps[i, : len(h)] = [sym[t] for t in h]
        rl[i], hl[i] = len(r), len(h)
    d = batch_edit_distance_native(refs, rl, hyps, hl)
    return float(d.sum()) / max(int(rl.sum()), 1)
