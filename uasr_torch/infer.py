"""Inference / decode entry (counterpart of ``uasr.infer``, ``--mode infer``).

Decodes batches on one device (greedy or exact prefix beam search) and
reports PER/CER plus decode RTF (decode wall time / audio seconds).
On CUDA the frontend, the BiGRU recurrence and the beam recursion go
through kernels K1, K2 and K4 when ``frontend.use_pallas``,
``model.gru_pallas`` and ``ctc.use_beam`` are set. A GAN or EODM
generator decodes through ``logits_fn`` (``train.GeneratorInfer``: the
frontend, segmentation, classifier and repeat merge it trained on), which
replaces the frontend and the model.
"""

from __future__ import annotations

import time
from typing import Iterable

import numpy as np
import torch

from uasr_torch import resolve_device
from uasr_torch.config import Config
from uasr_torch.data.dataset import Batch
from uasr_torch.frontend.features import FrontendState, compute_features
from uasr_torch.ops.decode import ctc_beam_search_decode, ctc_greedy_decode
from uasr_torch.ops.edit_distance import batch_edit_distance
from uasr_torch.vocab import Vocab

# which beam recursion the last run_inference ran: "cuda" (K4) or
# "reference" (its plain version, CPU tensors); None for greedy
LAST_BEAM_IMPL: str | None = None


def _decode_batch(cfg: Config, model, fstate: FrontendState, db: list[torch.Tensor],
                  logits_fn=None):
    global LAST_BEAM_IMPL
    audio, alen, labels, llen = db
    if logits_fn is not None:
        logits, out_len = logits_fn(audio, alen)
    elif audio.ndim == 3:  # precomputed features: frontend bypassed
        logits, out_len = model(audio, alen)
    else:
        feats, flen = compute_features(audio, alen, fstate, cfg.frontend)
        logits, out_len = model(feats, flen)
    if cfg.ctc.use_beam:
        hyps, hyp_len, _ = ctc_beam_search_decode(
            logits, out_len, cfg.ctc.beam_width, cfg.ctc.blank_id)
        LAST_BEAM_IMPL = "cuda" if logits.is_cuda else "reference"
    else:
        hyps, hyp_len = ctc_greedy_decode(logits, out_len, cfg.ctc.blank_id)
    dist = batch_edit_distance(labels, llen, hyps, hyp_len)
    # zero-length rows (batch padding) score nothing
    pad_row = alen == 0
    dist = torch.where(pad_row, 0, dist)
    hyp_len = torch.where(pad_row, 0, hyp_len)
    return hyps, hyp_len, dist.sum(), llen.sum()


def run_inference(
    cfg: Config,
    model: torch.nn.Module,
    frontend_state: FrontendState,
    batches: Iterable[Batch],
    vocab: Vocab | None = None,
    hyp_path: str | None = None,
    device="cuda",
    logits_fn=None,
) -> dict:
    """Decode + score. Returns {"per", "rtf", "audio_seconds", "errors",
    "ref_tokens"}. Runs on ``device`` (default CUDA; raises when no card
    is present rather than running on the CPU). ``logits_fn(audio,
    lengths) -> (logits, lengths)``, when given, computes the logits in
    place of ``model`` over ``compute_features``."""
    global LAST_BEAM_IMPL
    LAST_BEAM_IMPL = None
    if cfg.ctc.use_viterbi:
        raise NotImplementedError(
            "ctc.use_viterbi (HMM Viterbi decode, ops/viterbi.py) is not ported yet "
            "(ROADMAP.md Queue 1, slice 3: LM and HMM decode)")
    if cfg.ctc.lm_path:
        raise NotImplementedError(
            "ctc.lm_path needs ops/lm.py::load_lm, not ported yet (ROADMAP.md "
            "Queue 1, slice 3: LM and HMM decode); ctc_beam_search_decode takes a "
            "table directly")
    device = resolve_device(device)
    model = model.to(device).eval()
    fstate = frontend_state.to(device)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda *_: None)
    errs = total = 0
    audio_sec = 0.0
    wall = 0.0
    n_utts = 0
    hyp_f = open(hyp_path, "w") if hyp_path else None
    try:
        for b in batches:
            b_np = Batch(*(np.asarray(x) for x in b))
            db = [torch.as_tensor(b_np.audio, dtype=torch.float32).to(device)] + [
                torch.as_tensor(x, dtype=torch.long).to(device) for x in b_np[1:]]
            sync(device)
            t0 = time.perf_counter()
            with torch.inference_mode():
                hyps, hyp_len, e, t = _decode_batch(cfg, model, fstate, db, logits_fn)
            sync(device)
            wall += time.perf_counter() - t0
            hyps, hyp_len = hyps.cpu().numpy(), hyp_len.cpu().numpy()
            if b_np.audio.ndim == 3:
                # feature batches: lengths are frames
                audio_sec += float(np.sum(b_np.audio_lengths)) * cfg.frontend.frame_shift_ms / 1000.0
            else:
                audio_sec += float(np.sum(b_np.audio_lengths)) / cfg.frontend.sample_rate
            errs += int(e)
            total += int(t)
            if vocab is not None and hyp_f is not None:
                for i in range(hyps.shape[0]):
                    toks = vocab.decode_for_scoring(hyps[i, : int(hyp_len[i])])
                    hyp_f.write(f"utt{n_utts}\t{' '.join(toks)}\n")
                    n_utts += 1
    finally:
        if hyp_f is not None:
            hyp_f.close()
    return {
        "per": errs / max(total, 1),
        "rtf": wall / max(audio_sec, 1e-9),
        "audio_seconds": audio_sec,
        "errors": errs,
        "ref_tokens": total,
    }
