"""Iterative self-training, the wav2vec-U refinement stage (counterpart of
``uasr.selftrain``).

The teacher (a GAN / EODM generator or a CTC model) pseudo-labels the
unlabeled audio; a student trains on those labels with the ordinary
``CTCTrainer`` (CTC on the transcripts, or frame-level CE on the
teacher's forced-aligned per-frame tracks); the student then labels the
next round. Labelling runs the eval path under ``torch.no_grad`` with the
model in ``eval()``: the frontend (K1 on the card) and the encoder, then
greedy collapse or an LM-HMM Viterbi, and forced alignment, which are
plain PyTorch on the logits' device as the JAX package runs them outside
Pallas.

Over a precomputed-feature corpus (an SSL feature cache: [T, D]
examples) the frontend is bypassed, and with ``data.device_cache`` on one
CUDA device the student corpus is uploaded to the card once and each step
gathers its rows there (``data.cache.device_feature_batches``), as in the
JAX package. Over a mesh (``mesh``) every rank labels every batch (the
labels are the same everywhere), the teacher's weights that seed round 0
are broadcast from rank 0 (JAX replicates them over its mesh), and the
students train over the mesh.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Sequence

import numpy as np
import torch

from uasr_torch import resolve_device
from uasr_torch.checkpoint import CheckpointManager
from uasr_torch.config import Config
from uasr_torch.data.cache import device_feature_batches
from uasr_torch.data.dataset import aligned_batch_iterator, batch_iterator, prefetch
from uasr_torch.models.models import encoder_time_subsample
from uasr_torch.ops.decode import ctc_greedy_decode
from uasr_torch.ops.viterbi import ctc_forced_align, viterbi_lm_decode
from uasr_torch.train import CTCTrainer, TrainState, _apply, run_ctc_training


def make_gan_label_fn(gan_trainer, hmm=None, align_frames=False):
    """(audio batch) -> (hyps, hyp_lens, confidence) from a GAN / EODM
    generator (a ``GeneratorBase``, on the weights its ``gen`` holds):
    the merged posteriors -> greedy collapse, or with ``hmm`` the LM-HMM
    Viterbi path; confidence = masked mean max posterior.

    ``hmm``: a ``make_lm_decoder`` function, or ``lm_hmm``'s (log_init,
    log_trans, emit_cols) as tensors on the device.

    ``align_frames=True`` also forced-aligns each pseudo-label transcript
    against the generator's raw (pre-merge) frame posteriors as
    log(p + 1e-8), returning (hyps, hyp_lens, conf, frame_ids [B, T],
    frame_lens): per-frame targets for a ``train.mode: frame_ce`` student.
    The track is at the generator's rate (after ``frontend.downsample``),
    which the student subsamples by the downsample again, as in the JAX
    package (ROADMAP.md Queue 3)."""
    blank = gan_trainer.cfg.ctc.blank_id

    @torch.no_grad()
    def fn(batch):
        gan_trainer.gen.eval()
        db = batch if isinstance(batch, list) else gan_trainer.to_device(batch)
        raw_probs, raw_len, probs, out_len, logits = gan_trainer._gen_probs_full(
            None, db[0], db[1])
        hyps, hyp_len = _decode(logits, out_len, blank, hmm)
        conf = _mean_max(probs, out_len)
        if not align_frames:
            return hyps, hyp_len, conf
        frame_ids, _ = ctc_forced_align(torch.log(raw_probs + 1e-8), raw_len, hyps, hyp_len,
                                        blank)
        return hyps, hyp_len, conf, frame_ids, raw_len

    return fn


def make_ctc_label_fn(ctc_trainer: CTCTrainer, params=None, hmm=None, align_frames=False):
    """(audio batch) -> (hyps, hyp_lens, confidence) from a CTC model
    (``params`` None = the weights its ``model`` holds). ``hmm``: see
    ``make_gan_label_fn``.

    ``align_frames=True``: the alignment is forced at the logits rate and
    repeated by the encoder's stride times the frontend's downsample (the
    stride alone for [B, T, D] feature batches, which bypass the
    frontend), so the track lands at the model-input frame rate (what a
    student of any architecture consumes); its length is out_len x that
    factor."""
    cfg = ctc_trainer.cfg

    @torch.no_grad()
    def fn(batch):
        ctc_trainer.model.eval()
        db = batch if isinstance(batch, list) else ctc_trainer.to_device(batch)
        logits, out_len = _apply(ctc_trainer.model, params, *ctc_trainer._feats(db[0], db[1]))
        stride = encoder_time_subsample(cfg.model)
        if db[0].ndim == 2:
            stride *= cfg.frontend.downsample
        hyps, hyp_len = _decode(logits, out_len, cfg.ctc.blank_id, hmm)
        conf = _mean_max(torch.softmax(logits.float(), -1), out_len)
        if not align_frames:
            return hyps, hyp_len, conf
        frame_ids, _ = ctc_forced_align(logits, out_len, hyps, hyp_len, cfg.ctc.blank_id)
        if stride > 1:
            frame_ids = frame_ids.repeat_interleave(stride, dim=1)
        return hyps, hyp_len, conf, frame_ids, out_len * stride

    return fn


def _decode(logits, out_len, blank_id, hmm):
    if hmm is None:
        return ctc_greedy_decode(logits, out_len, blank_id)
    if callable(hmm):  # a make_lm_decoder function (bigram or trigram)
        hyps, hyp_len, _ = hmm(logits, out_len)
        return hyps, hyp_len
    hyps, hyp_len, _ = viterbi_lm_decode(logits, out_len, hmm, blank_id)
    return hyps, hyp_len


def _mean_max(probs: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    T = probs.shape[1]
    mask = torch.arange(T, device=probs.device)[None, :] < lengths[:, None]
    mx = probs.amax(dim=-1)
    return torch.sum(mx * mask, dim=1) / lengths.clamp_min(1)


def _existing_ckpt_step(ckpt_dir: str) -> int | None:
    """Newest retained step under ``ckpt_dir`` (``<step>.pt`` files), or
    None; creates nothing."""
    if not os.path.isdir(ckpt_dir):
        return None
    return CheckpointManager(ckpt_dir).latest_step()


def pseudo_label(
    label_fn: Callable,
    examples: Sequence[tuple[np.ndarray, list[int]]],
    batch_size: int,
    max_audio_samples: int,
    max_label_len: int,
    conf_threshold: float = 0.0,
    min_labels: int = 1,
) -> tuple[list, dict]:
    """Label every example with the teacher; keep those whose confidence
    clears the threshold. Returns (pseudo-labelled examples: (audio, ids)
    or, from an aligning labeller, (audio, ids, frame labels); stats)."""
    out = []
    confs = []
    it = batch_iterator(examples, batch_size, max_audio_samples, max_label_len, shuffle=False,
                        drop_remainder=False, num_epochs=1)
    idx = 0
    for batch in it:
        res = [x.cpu().numpy() for x in label_fn(batch)]
        aligned = len(res) == 5
        hyps, hyp_len, conf = res[:3]
        for b in range(len(hyp_len)):
            audio = batch.audio[b, : batch.audio_lengths[b]]
            ids = hyps[b, : hyp_len[b]].tolist()
            confs.append(float(conf[b]))
            if conf[b] >= conf_threshold and len(ids) >= min_labels:
                if aligned:
                    out.append((audio, ids, res[3][b, : res[4][b]].tolist()))
                else:
                    out.append((audio, ids))
            idx += 1
    stats = {
        "labeled": len(out),
        "total": idx,
        "kept_frac": len(out) / max(idx, 1),
        "mean_conf": float(np.mean(confs)) if confs else 0.0,
    }
    return out, stats


@torch.no_grad()
def broadcast_params(params: dict, mesh, device) -> dict:
    """Rank 0's whole tensors of ``params`` on every rank of ``mesh`` (the
    same dict without one), on ``device``."""
    if mesh is None:
        return params
    out = {}
    for k in sorted(params):
        t = params[k].detach().to(device=device, dtype=torch.float32).contiguous()
        torch.distributed.broadcast(t, src=0)
        out[k] = t
    return out


def self_train(
    cfg: Config,
    label_fn: Callable,
    unlabeled: Sequence[tuple[np.ndarray, list[int]]],
    rounds: int = 1,
    conf_threshold: float = 0.0,
    dev_batches_fn=None,
    steps_per_round: int | None = None,
    gold: Sequence[tuple[np.ndarray, list[int]]] = (),
    init_params: dict | None = None,
    log: Callable = print,
    device="cuda",
    mesh=None,
) -> tuple[CTCTrainer, TrainState, list[dict]]:
    """Iterate: pseudo-label -> student -> the student labels the next
    round. Round r trains into ``<model_dir>/selftrain_r{r}`` with seed
    train.seed + r, for ``steps_per_round`` steps (train.total_steps when
    None).

    ``unlabeled`` examples' label field is ignored. ``gold`` examples are
    mixed into every round (semi-supervised); not with aligned labels,
    which gold utterances lack. ``init_params`` (a state dict for the
    student's architecture, e.g. a GAN generator's for a ``classifier``
    student) initialises round 0 from the teacher, only in an empty round-0
    directory: a checkpoint there is resumed instead.

    From a labeller built with ``align_frames=True`` the rounds train with
    ``train.mode: frame_ce`` on the forced-aligned tracks, else with CTC on
    the transcripts. Dev eval decodes and scores PER either way.

    Over [T, D] feature examples the caps are ``data.max_frames``, and with
    ``data.device_cache`` on a CUDA ``device`` each round's corpus is
    uploaded to the card once. Returns (the last student's trainer, its
    state, per-round stats)."""
    device = resolve_device(device)
    feats_corpus = np.ndim(unlabeled[0][0]) == 2
    max_samples = (cfg.data.max_frames if feats_corpus
                   else int(cfg.data.max_audio_seconds * cfg.frontend.sample_rate))
    history = []
    trainer = state = None
    for r in range(rounds):
        labeled, stats = pseudo_label(label_fn, unlabeled, cfg.data.batch_size, max_samples,
                                      cfg.data.max_label_len, conf_threshold)
        log(f"[selftrain] round {r}: kept {stats['labeled']}/{stats['total']} "
            f"(mean conf {stats['mean_conf']:.3f})")
        if not labeled:
            raise ValueError("self-training kept 0 utterances; lower conf_threshold")
        aligned = len(labeled[0]) == 3
        if aligned and gold:
            raise ValueError(
                "gold mix-in is not supported with frame-aligned pseudo-labels (gold "
                "utterances carry no alignment track); drop --gold-list or "
                "--align-pseudo-labels")
        labeled = list(gold) + labeled
        round_train = dataclasses.replace(
            cfg.train, mode="frame_ce" if aligned else "ctc",
            total_steps=cfg.train.total_steps if steps_per_round is None else steps_per_round)
        round_cfg = cfg.replace(model_dir=f"{cfg.model_dir}/selftrain_r{r}", train=round_train)
        if aligned:
            max_track = max(len(al) for _a, _i, al in labeled)
            batches = prefetch(aligned_batch_iterator(
                labeled, cfg.data.batch_size, max_samples, cfg.data.max_label_len, max_track,
                seed=cfg.train.seed + r))
        elif feats_corpus and cfg.data.device_cache and device.type == "cuda":
            batches = prefetch(device_feature_batches(
                labeled, cfg.data.batch_size, max_samples, cfg.data.max_label_len,
                seed=cfg.train.seed + r, device=device))
        else:
            batches = prefetch(batch_iterator(labeled, cfg.data.batch_size, max_samples,
                                              cfg.data.max_label_len, seed=cfg.train.seed + r))
        if r == 0 and init_params is not None and \
                _existing_ckpt_step(f"{round_cfg.model_dir}/ckpt") is None:
            trainer = CTCTrainer(round_cfg, device=device, mesh=mesh)
            init = broadcast_params(init_params, mesh, trainer.device)
            plan = trainer.plans[0]
            trainer.model.load_state_dict(plan.shard(init) if plan is not None else init)
            trainer, state = run_ctc_training(round_cfg, batches, dev_batches_fn=dev_batches_fn,
                                              trainer=trainer, state=trainer.init_state())
        else:
            # a killed run of this round left a checkpoint: restore-latest
            # resumes it rather than re-seeding from the teacher
            if r == 0 and init_params is not None:
                log("[selftrain] round 0: existing student checkpoint found — resuming it "
                    "(teacher init only seeds a fresh directory)")
            trainer, state = run_ctc_training(round_cfg, batches, dev_batches_fn=dev_batches_fn,
                                              device=device, mesh=mesh)
        stats["round"] = r
        history.append(stats)
        label_fn = make_ctc_label_fn(trainer, state.params, align_frames=aligned)
    return trainer, state, history
