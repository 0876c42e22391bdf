"""Training (counterpart of ``uasr.train``): the optimizer, supervised
CTC (``CTCTrainer``, ``run_ctc_training``), the unsupervised generator's
GAN and EODM training (``GANTrainer``, ``EODMTrainer``,
``run_gan_training``, ``run_eodm_training``), its decode view
(``GeneratorInfer``), label-free selection (``UnsupSelector``) and the
checkpoint keepers.

One training step: frontend (K1 for CUDA tensors) -> optional SpecAugment
-> encoder (the BiGRU through K2 forward / K2-bwd backward; the GRU layers
of ``uni_gru`` and ``lc_bigru`` through K5 / K5-bwd or K8; the attention of
``transformer`` and ``conformer`` through K6 / K6-bwd) -> CTC loss
(K3 / K3-bwd with ``ctc.use_pallas``, else the scan loss) -> gradients ->
global-norm clip -> Adam, all on one device. Eval decodes greedily (or
with the prefix beam) and scores the edit distance.

Parity with the JAX package, which uses optax:

- the schedule is called with the number of updates made so far (0 for
  the first step), as optax calls it; ``warmup_rsqrt`` floors it at 1;
- the clip scales by max_norm / g_norm only when g_norm >= max_norm, with
  no eps (``optax.clip_by_global_norm``); Adam is ``optax.adam``'s
  update order (b1 0.9, b2 0.999, eps 1e-8, eps_root 0);
- ``grad_norm`` is the norm of the unclipped gradients;
- parameters are f32 and cast to the compute dtype inside ``forward``.

The state is a ``TrainState(step, params, opt_state)`` of tensors. The
step runs the model on ``state.params`` (``torch.func.functional_call``),
and the update writes the new parameters and moments into the state's own
tensors in place, which saves a copy of each.

One unsupervised step: frontend (K1) -> optional k-means segmentation
-> ``PhoneClassifier`` -> softmax -> optional repeat merge -> the critic
(``PhoneDiscriminator``, f32) and / or EODM, plus the output
regularisers and the semi-supervised CTC mix-in (K3 / K3-bwd with
``ctc.use_pallas``). ``GANTrainer.d_step`` updates the critic on a
detached fake batch, with the gradient penalty's double backward;
``g_step`` updates the generator through the critic. The GAN optimizers
are Adam with b1 = ``gan.adam_b1`` and b2 = 0.9, at ``g_lr`` / ``d_lr``
or ``train.lr_schedule``'s shape at those peaks; ``d_weight_decay`` adds
coupled L2 to the critic's gradient before the clip (optax's
``add_decayed_weights``), not AdamW.

Divergences, recorded in ROADMAP.md: random streams differ (SpecAugment
draws from a ``torch.Generator`` seeded by (train.seed, step), and the
gradient penalty's interpolation weights by (train.seed, step, critic
step), so a resumed run draws what an unbroken one would; JAX splits one
``jax.random`` key); the GAN's text batches are the JAX package's
numpy order, fast-forwarded on resume past the batches the restored
steps used; a ``GANState`` checkpoint is one ``torch.save`` file holding
both nets, both optimizer states and the step; dropout
(``model.dropout``) acts in training here, while JAX's ``CTCTrainer``
never passes flax a dropout key.

Not ported yet, each raising ``NotImplementedError`` that names its
ROADMAP.md Queue 1 item: ``train.mode: frame_ce`` and ``ssl``,
``grad_accum > 1``, meshes and several devices, and batches of
precomputed 3-D features.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import math
import os
import signal
import threading
import time
from typing import Any, Iterator, NamedTuple

import numpy as np
import torch
from torch.func import functional_call

from uasr_torch import resolve_device
from uasr_torch.checkpoint import CheckpointManager
from uasr_torch.config import Config
from uasr_torch.data.dataset import Batch
from uasr_torch.frontend.features import compute_features, frontend_state_from_config
from uasr_torch.frontend.specaugment import spec_augment
from uasr_torch.metrics import MetricWriter, log_stdout
from uasr_torch.models.models import build_discriminator, build_model
from uasr_torch.ops.ctc import ctc_loss
from uasr_torch.ops.cuda_ctc import ctc_loss_kernel
from uasr_torch.ops.decode import ctc_beam_search_decode, ctc_greedy_decode
from uasr_torch.ops.edit_distance import batch_edit_distance
from uasr_torch.ops.eodm import device_ngram_tables, eodm_loss
from uasr_torch.ops.wgan import bce_d_loss_fn, bce_g_loss_fn, d_loss_fn, g_loss_fn


class TrainState(NamedTuple):
    step: int
    params: dict  # name -> f32 tensor (leaf, requires grad)
    opt_state: dict  # {"count": int, "mu": {name: tensor}, "nu": {name: tensor}}


class GANState(NamedTuple):
    step: int  # generator updates made
    g_params: dict
    d_params: dict
    g_opt: dict
    d_opt: dict


# ------------------------------------------------------------ optimizer


def make_schedule(cfg: Config):
    """Learning rate as a function of the number of updates made so far."""
    t = cfg.train
    warm = max(t.warmup_steps, 1)
    if t.lr_schedule == "constant":
        return lambda step: t.lr
    if t.lr_schedule == "warmup_rsqrt":

        def sched(step):
            step = max(step, 1)
            return t.lr * min(step / warm, math.sqrt(warm / step))

        return sched

    # warmup + exponential decay (reference: warmup_exponential_decay)
    def sched(step):
        ramp = min(step / warm, 1.0)
        decay = t.decay_rate ** (max(step - t.warmup_steps, 0) / max(t.decay_steps, 1))
        return t.lr * ramp * decay

    return sched


def global_norm(tensors) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in tensors))


class ClipAdam:
    """``optax.chain(clip_by_global_norm(max_norm), adam(schedule, b1, b2,
    eps))`` on dicts of tensors, with ``optax.add_decayed_weights
    (weight_decay)`` chained before the clip when ``weight_decay > 0``
    (coupled L2: ``weight_decay * param`` added to the gradient);
    ``update`` also returns the global norm before the clip."""

    def __init__(self, schedule, max_norm: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.0):
        self.schedule, self.max_norm = schedule, max_norm
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay

    def init(self, params: dict) -> dict:
        return {"count": 0,
                "mu": {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()},
                "nu": {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}}

    @torch.no_grad()
    def update(self, grads: dict, opt_state: dict, params: dict | None = None):
        """(updates, new opt_state, global norm before the clip). The
        moments are updated in place; ``params`` are needed with weight
        decay."""
        if self.weight_decay > 0:
            grads = {k: g + self.weight_decay * params[k] for k, g in grads.items()}
        g_norm = global_norm(grads.values())
        keep = g_norm < self.max_norm
        count = opt_state["count"] + 1
        f32 = torch.float32
        dev = g_norm.device
        bc1 = (1.0 - torch.tensor(self.b1, dtype=f32) ** count).to(dev)
        bc2 = (1.0 - torch.tensor(self.b2, dtype=f32) ** count).to(dev)
        step_size = -float(np.float32(self.schedule(opt_state["count"])))
        updates = {}
        for k, g in grads.items():
            g = torch.where(keep, g, (g / g_norm) * self.max_norm)
            mu = opt_state["mu"][k].mul_(self.b1).add_((1 - self.b1) * g)
            nu = opt_state["nu"][k].mul_(self.b2).add_((1 - self.b2) * torch.square(g))
            updates[k] = ((mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)) * step_size
        return updates, dict(opt_state, count=count), g_norm


def make_optimizer(cfg: Config, lr=None, b1: float = 0.9, b2: float = 0.999,
                   weight_decay: float = 0.0) -> ClipAdam:
    """Global-norm clip at ``train.grad_clip``, then Adam on ``lr`` (a
    schedule, a constant, or None for ``train.lr_schedule``)."""
    if cfg.train.grad_accum > 1:
        raise NotImplementedError(
            "train.grad_accum > 1 is not ported yet (ROADMAP.md Queue 1, slice 5: scale)")
    if lr is None:
        lr = make_schedule(cfg)
    sched = lr if callable(lr) else (lambda step: lr)
    return ClipAdam(sched, cfg.train.grad_clip, b1=b1, b2=b2, weight_decay=weight_decay)


def _to_device(batch, device) -> list[torch.Tensor]:
    """A numpy ``Batch`` as tensors on ``device`` (audio f32, the rest int64)."""
    b = Batch(*(np.asarray(x) for x in batch[:4]))
    if b.audio.ndim == 3:
        raise NotImplementedError(
            "batches of precomputed [B, T, D] features are not ported yet (ROADMAP.md "
            "Queue 1, item 10: SSL and feature caches)")
    return [torch.as_tensor(b.audio, dtype=torch.float32).to(device)] + [
        torch.as_tensor(x, dtype=torch.long).to(device) for x in b[1:]]


def _leaves(params: dict) -> dict:
    """``params`` with every tensor a leaf that requires grad."""
    return {k: p if p.requires_grad else p.requires_grad_() for k, p in params.items()}


@torch.no_grad()
def _apply_updates(params: dict, updates: dict) -> None:
    for k, u in updates.items():
        params[k].add_(u)


# ---------------------------------------------------------- CTC trainer


class CTCTrainer:
    """Supervised CTC training and eval on one device."""

    def __init__(self, cfg: Config, device="cuda"):
        if cfg.train.mode == "frame_ce":
            raise NotImplementedError(
                "train.mode frame_ce is not ported yet (ROADMAP.md Queue 1, slice 3: frame-CE)")
        if cfg.train.mode in ("gan", "gan+eodm", "eodm"):
            raise ValueError(
                f"train.mode {cfg.train.mode!r} trains the generator through GANTrainer / "
                "EODMTrainer (run_gan_training, run_eodm_training), not CTCTrainer")
        if cfg.train.mode != "ctc":
            raise NotImplementedError(
                f"train.mode {cfg.train.mode!r} is not ported yet (ROADMAP.md Queue 1, "
                "item 10: SSL and feature caches)")
        if cfg.parallel.model_parallel > 1:
            raise NotImplementedError(
                "parallel.model_parallel > 1 (a device mesh) is not ported yet (ROADMAP.md "
                "Queue 1, slice 5: distribution)")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = build_model(cfg.model, cfg.dim_output, cfg.frontend.dim_input,
                                 generator=torch.Generator().manual_seed(cfg.train.seed),
                                 device=self.device)
        self.optimizer = make_optimizer(cfg)
        self._frontend_state = None

    @property
    def frontend_state(self):
        if self._frontend_state is None:
            self._frontend_state = frontend_state_from_config(self.cfg.frontend,
                                                              device=self.device)
        return self._frontend_state

    def to_device(self, batch) -> list[torch.Tensor]:
        """A numpy ``Batch`` as tensors on the trainer's device."""
        return _to_device(batch, self.device)

    def step_generator(self, step: int) -> torch.Generator:
        """SpecAugment's random stream for ``step``: a function of
        (train.seed, step), so a resumed run draws what an unbroken one
        would."""
        return torch.Generator().manual_seed(self.cfg.train.seed * 1_000_003 + int(step))

    def init_state(self) -> TrainState:
        """The model's freshly drawn parameters (shapes come from the
        config) and a zero optimizer state."""
        params = dict(self.model.named_parameters())
        return TrainState(0, params, self.optimizer.init(params))

    def _loss(self, params: dict, db: list[torch.Tensor], generator: torch.Generator):
        cfg = self.cfg
        audio, alen, labels, llen = db
        with torch.no_grad():  # the frontend has no parameters
            feats, flen = compute_features(audio, alen, self.frontend_state, cfg.frontend)
            if cfg.frontend.specaug_time_masks or cfg.frontend.specaug_freq_masks:
                feats = spec_augment(generator, feats, flen, cfg.frontend)
        logits, out_len = functional_call(self.model, params, (feats, flen))
        loss_fn = ctc_loss_kernel if cfg.ctc.use_pallas else ctc_loss
        loss = loss_fn(logits, out_len, labels, llen, cfg.ctc.blank_id).mean()
        return loss, {"ctc_loss": loss.detach(), "loss": loss.detach()}

    def loss_and_grads(self, params: dict, batch, generator: torch.Generator):
        """(aux, grads) of the mean CTC loss at ``params`` in train mode;
        ``batch`` is a numpy ``Batch`` or its tensors on the device."""
        self.model.train()
        params = _leaves(params)
        db = batch if isinstance(batch, list) else self.to_device(batch)
        loss, aux = self._loss(params, db, generator)
        grads = torch.autograd.grad(loss, list(params.values()))
        return aux, dict(zip(params, grads))

    def train_step(self, state: TrainState, batch, generator: torch.Generator | None = None):
        """One update. Returns (new state, aux) with aux's values as 0-d
        tensors on the device (``loss``, ``ctc_loss``, ``grad_norm``)."""
        aux, grads = self.loss_and_grads(state.params, batch,
                                         generator or self.step_generator(state.step))
        updates, opt_state, g_norm = self.optimizer.update(grads, state.opt_state)
        _apply_updates(state.params, updates)
        aux["grad_norm"] = g_norm
        return TrainState(state.step + 1, state.params, opt_state), aux

    @torch.no_grad()
    def eval_step(self, params: dict, batch) -> tuple[torch.Tensor, torch.Tensor]:
        """Decode + edit distance -> (errors, reference tokens), summed over
        the batch. PER = sum(err) / sum(ref)."""
        self.model.eval()
        audio, alen, labels, llen = self.to_device(batch)
        feats, flen = compute_features(audio, alen, self.frontend_state, self.cfg.frontend)
        logits, out_len = functional_call(self.model, params, (feats, flen))
        ctc = self.cfg.ctc
        if ctc.use_beam:
            hyps, hyp_len, _ = ctc_beam_search_decode(logits, out_len, ctc.beam_width,
                                                      ctc.blank_id)
        else:
            hyps, hyp_len = ctc_greedy_decode(logits, out_len, ctc.blank_id)
        dist = batch_edit_distance(labels, llen, hyps, hyp_len)
        return dist.sum(), llen.sum()

    def evaluate(self, params: dict, batches) -> float:
        errs, total = 0, 0
        for b in batches:
            e, t = self.eval_step(params, b[:4])
            errs += int(e)
            total += int(t)
        return errs / max(total, 1)


# ------------------------------------------------- checkpoint keepers


class BestCheckpointKeeper:
    """Best-metric checkpoint under ``model_dir/best_ckpt``: the checkpoint
    is committed before score.json is written, so a kill between the two
    never records a best score without its checkpoint. The recorded best
    survives resume. ``higher_is_better`` False for dev PER."""

    def __init__(self, model_dir: str, higher_is_better: bool):
        self._sign = 1.0 if higher_is_better else -1.0
        self.ckpt = CheckpointManager(os.path.join(model_dir, "best_ckpt"), max_to_keep=1)
        self._score_path = os.path.join(model_dir, "best_ckpt", "score.json")
        self.best = -np.inf
        if os.path.exists(self._score_path):
            with open(self._score_path) as f:
                self.best = self._sign * float(json.load(f)["score"])

    def update(self, score: float, step: int, state) -> bool:
        if self._sign * score > self.best:
            self.best = self._sign * score
            self.ckpt.save(step, state)
            self.ckpt.wait()
            with open(self._score_path, "w") as f:
                json.dump({"score": float(score), "step": int(step)}, f)
            return True
        return False

    def close(self):
        self.ckpt.close()


class PreemptionGuard:
    """On SIGTERM/SIGINT the training loop finishes the current step,
    saves and exits cleanly; a second signal interrupts hard."""

    def __init__(self):
        self.triggered = False
        self._prev: dict = {}
        if threading.current_thread() is threading.main_thread():
            for sig in (signal.SIGTERM, signal.SIGINT):
                try:
                    prev = signal.signal(sig, self._handle)
                except (ValueError, OSError):
                    continue
                # a stale guard left by an earlier run in this process that
                # exited through an exception: inherit its saved handler
                owner = getattr(prev, "__self__", None)
                if isinstance(owner, PreemptionGuard):
                    prev = owner._prev.get(sig, signal.SIG_DFL)
                self._prev[sig] = prev

    def _handle(self, signum, frame):
        self.triggered = True
        prev = self._prev.get(signum)
        if prev is not None:
            signal.signal(signum, prev)

    def close(self):
        """Restore the previous handlers."""
        for sig, prev in self._prev.items():
            try:
                if signal.getsignal(sig) == self._handle:
                    signal.signal(sig, prev)
            except (ValueError, OSError):
                pass
        self._prev = {}


class UnsupSelector:
    """Label-free checkpoint selection: greedy dev transcriptions scored
    by mean LM token log-prob minus KL(token usage || text unigram) minus
    the bigram coverage KL (``ops.lm.unsup_selection_score``); the best
    checkpoint is kept under ``model_dir/best_ckpt``."""

    def __init__(self, cfg: Config):
        from uasr_torch.ops.lm import load_lm, load_unigram

        self.lm = load_lm(cfg.gan.select_lm_path)
        V = cfg.dim_output
        if self.lm.shape not in ((V + 1, V), (V + 1, V + 1, V)):
            raise ValueError(
                f"gan.select_lm_path table shape {self.lm.shape} does not match the model "
                f"vocabulary ([{V + 1}, {V}] bigram or [{V + 1}, {V + 1}, {V}] trigram "
                "expected) — was the LM built with `prepare lm` on this recipe's vocab?")
        uni = load_unigram(cfg.gan.select_lm_path)
        if uni is None:  # an lm.npz without the unigram: the start row
            uni = np.exp(self.lm[V] if self.lm.ndim == 2 else self.lm[V, V])
        self.unigram = uni
        self.kl_weight = cfg.gan.select_kl_weight
        self.coverage_weight = cfg.gan.select_coverage_weight
        self._keeper = BestCheckpointKeeper(cfg.model_dir, higher_is_better=True)

    def score(self, trainer: GeneratorBase, g_params, batches) -> dict:
        from uasr_torch.ops.lm import unsup_selection_score

        hyps, lens = trainer.decode_hyps(g_params, batches)
        return unsup_selection_score(hyps, lens, self.lm, self.unigram, self.kl_weight,
                                     coverage_weight=self.coverage_weight)

    @property
    def best(self) -> float:
        return self._keeper.best

    def update(self, score: float, step: int, state) -> bool:
        return self._keeper.update(score, step, state)

    def close(self):
        self._keeper.close()


# ----------------------------------------------------- unsupervised trainers


def _apply(module, params, *args):
    """``module`` on ``params`` (its own weights when None)."""
    return module(*args) if params is None else functional_call(module, params, args)


class GeneratorBase:
    """What the trainers built on the ``PhoneClassifier`` generator share
    (GAN, EODM, decode): the frontend, optional k-means segmentation, the
    CTC-style repeat merge and the output regularisers, so every
    unsupervised objective and the decode see the same inputs."""

    def _init_generator(self, cfg: Config, device, centroids=None):
        if cfg.parallel.model_parallel > 1:
            raise NotImplementedError(
                "parallel.model_parallel > 1 (a device mesh) is not ported yet (ROADMAP.md "
                "Queue 1, item 14: distribution)")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.gen = build_model(dataclasses.replace(cfg.model, encoder="classifier"),
                               cfg.dim_output, cfg.frontend.dim_input,
                               generator=torch.Generator().manual_seed(cfg.train.seed),
                               device=self.device)
        self._frontend_state = None
        self.centroids = None
        if cfg.gan.segmenter == "kmeans":
            if centroids is None and not cfg.gan.centroids_path:
                raise ValueError("gan.segmenter=kmeans needs centroids (path or array)")
            if centroids is None:
                centroids = np.load(cfg.gan.centroids_path)["centroids"]
            self.centroids = torch.as_tensor(np.asarray(centroids), dtype=torch.float32,
                                             device=self.device)

    @property
    def model(self) -> torch.nn.Module:
        """The generator (the CTC trainers' name for the decoded model)."""
        return self.gen

    @property
    def frontend_state(self):
        if self._frontend_state is None:
            self._frontend_state = frontend_state_from_config(self.cfg.frontend,
                                                              device=self.device)
        return self._frontend_state

    def to_device(self, batch) -> list[torch.Tensor]:
        return _to_device(batch, self.device)

    @torch.no_grad()
    def _gen_feats(self, audio: torch.Tensor, alen: torch.Tensor):
        """Features of a [B, L] audio batch (K1 on the card), segmented
        with ``gan.segmenter=kmeans``."""
        cfg = self.cfg
        feats, flen = compute_features(audio, alen, self.frontend_state, cfg.frontend)
        if self.centroids is not None:
            from uasr_torch.ops.segment import kmeans_segment_frontend

            quant = None
            if cfg.gan.segment_on_raw:
                raw_cfg = dataclasses.replace(cfg.frontend, cmvn="none")
                quant, _ = compute_features(audio, alen, self.frontend_state, raw_cfg)
            feats, flen = kmeans_segment_frontend(
                feats, flen, self.centroids, cfg.gan.max_segments or None,
                mode_radius=cfg.gan.segment_mode_radius, quant_feats=quant)
        return feats, flen

    def _gen_probs_full(self, g_params, audio, alen):
        """(raw frame posteriors, raw lengths, post-merge probs, post-merge
        lengths, post-merge logits). The raw view feeds the smoothness
        penalty, which must see the stream before the merge erases the
        flicker it punishes; log(pooled + 1e-8) acts as the merged logits
        (softmax(log p) == p on the simplex)."""
        feats, flen = self._gen_feats(audio, alen)
        return self._probs_from_feats(g_params, feats, flen)

    def _probs_from_feats(self, g_params, feats, flen):
        """``_gen_probs_full`` after the frontend and segmentation."""
        logits, out_len = _apply(self.gen, g_params, feats, flen)
        raw_probs = torch.softmax(logits, -1)
        probs, n = raw_probs, out_len
        if self.cfg.gan.merge_repeats:
            from uasr_torch.ops.segment import merge_repeats_drop_blank

            probs, n = merge_repeats_drop_blank(raw_probs, out_len, self.cfg.ctc.blank_id)
            logits = torch.log(probs + 1e-8)
        return raw_probs, out_len, probs, n, logits

    def _ctc(self, logits, lengths, labels, label_lengths) -> torch.Tensor:
        loss_fn = ctc_loss_kernel if self.cfg.ctc.use_pallas else ctc_loss
        return loss_fn(logits, lengths, labels, label_lengths, self.cfg.ctc.blank_id).mean()

    def _sup_ctc_term(self, g_params, labeled: list[torch.Tensor]) -> torch.Tensor:
        """Supervised CTC on a small labeled batch (the semi-supervised
        mix-in), on the raw generator stream (no merge)."""
        audio, alen, labels, llen = labeled
        feats, flen = self._gen_feats(audio, alen)
        logits, out_len = _apply(self.gen, g_params, feats, flen)
        return self._ctc(logits, out_len, labels, llen)

    @staticmethod
    def _entropy(probs, lengths):
        """Masked mean per-position entropy of posteriors [B, T, V]."""
        mask = torch.arange(probs.shape[1], device=probs.device)[None, :] < lengths[:, None]
        ent = -torch.sum(probs * torch.log(probs + 1e-8), -1)
        return torch.sum(ent * mask) / torch.clamp(mask.sum(), min=1)

    def _aux_penalties(self, probs, lengths, aux: dict, loss, raw_probs=None, raw_len=None):
        """Entropy (peakiness), diversity (anti-collapse) and smoothness
        (anti-flicker, on the pre-merge stream) penalties."""
        g = self.cfg.gan
        if g.entropy_weight > 0:
            ent = self._entropy(probs, lengths)
            aux["g_entropy"] = ent
            loss = loss + g.entropy_weight * ent
        if g.diversity_weight > 0:
            T = probs.shape[1]
            mask = (torch.arange(T, device=probs.device)[None, :] < lengths[:, None])[..., None]
            mean_p = torch.sum(probs * mask, dim=(0, 1)) / torch.clamp(mask.sum(), min=1)
            div = -torch.sum(mean_p * torch.log(mean_p + 1e-8))
            aux["g_diversity"] = div
            loss = loss - g.diversity_weight * div
        if g.smoothness_weight > 0:
            p = probs if raw_probs is None else raw_probs
            plen = lengths if raw_probs is None else raw_len
            T = p.shape[1]
            # pair (t, t + 1) valid iff t + 1 < len
            pair = torch.arange(T - 1, device=p.device)[None, :] < (plen[:, None] - 1)
            sq = torch.sum((p[:, 1:] - p[:, :-1]) ** 2, -1)
            sm = torch.sum(sq * pair) / torch.clamp(pair.sum(), min=1)
            aux["g_smooth"] = sm
            loss = loss + g.smoothness_weight * sm
        return loss

    @torch.no_grad()
    def _decode(self, g_params, db):
        _, _, _, n, logits = self._gen_probs_full(g_params, db[0], db[1])
        return ctc_greedy_decode(logits, n, self.cfg.ctc.blank_id)

    def decode_hyps(self, g_params, batches):
        """Greedy hypotheses of the merged stream for audio batches, label
        free (unsupervised selection): (per-utterance id arrays, lengths)."""
        hyps, lens = [], []
        for b in batches:
            h, hl = self._decode(g_params, self.to_device(b))
            h, hl = h.cpu().numpy(), hl.cpu().numpy()
            for i in range(h.shape[0]):
                hyps.append(h[i])
                lens.append(int(hl[i]))
        return hyps, np.asarray(lens)

    def evaluate_per(self, g_params, batches) -> float:
        """Merged-stream greedy collapse -> PER against the labels."""
        errs, total = 0, 0
        for b in batches:
            db = self.to_device(b)
            hyps, hyp_len = self._decode(g_params, db)
            errs += int(batch_edit_distance(db[2], db[3], hyps, hyp_len).sum())
            total += int(db[3].sum())
        return errs / max(total, 1)


class GANTrainer(GeneratorBase):
    """Adversarial unsupervised training: the generator on acoustic
    features against the critic over phone distributions, WGAN-GP or bce,
    ``gan.disc_steps`` critic steps per generator step, the optional EODM
    term (``tables``: the joint ``gan+eodm`` mode) and the optional
    supervised CTC mix-in."""

    def __init__(self, cfg: Config, device="cuda", centroids=None, tables=None):
        self._init_generator(cfg, device, centroids)
        self.disc = build_discriminator(cfg.model, cfg.dim_output,
                                        generator=torch.Generator().manual_seed(
                                            cfg.train.seed + 1),
                                        device=self.device)
        self.tables = tables

        def _lr(peak):
            # gan.use_lr_schedule: train.lr_schedule's shape at the GAN peak
            if not cfg.gan.use_lr_schedule:
                return peak
            return make_schedule(cfg.replace(train=dataclasses.replace(cfg.train, lr=peak)))

        g = cfg.gan
        self.g_opt = make_optimizer(cfg, lr=_lr(g.g_lr), b1=g.adam_b1, b2=0.9)
        self.d_opt = make_optimizer(cfg, lr=_lr(g.d_lr), b1=g.adam_b1, b2=0.9,
                                    weight_decay=g.d_weight_decay)

    def init_state(self) -> GANState:
        gp, dp = dict(self.gen.named_parameters()), dict(self.disc.named_parameters())
        return GANState(0, gp, dp, self.g_opt.init(gp), self.d_opt.init(dp))

    def eps_generator(self, step: int, k: int) -> torch.Generator:
        """The gradient penalty's random stream for critic step ``k`` before
        generator step ``step``: a function of (train.seed, step, k), so a
        resumed run draws what an unbroken one would."""
        seed = np.random.SeedSequence([self.cfg.train.seed, int(step), int(k)])
        return torch.Generator().manual_seed(int(seed.generate_state(1)[0]))

    def _real_dist(self, ids: torch.Tensor) -> torch.Tensor:
        """One-hot real text, smoothed toward uniform by
        ``gan.real_label_smooth``."""
        V = self.cfg.dim_output
        real = torch.nn.functional.one_hot(ids, V).float()
        s = self.cfg.gan.real_label_smooth
        if s > 0:
            real = real * (1.0 - s) + s / V
        return real

    def d_step(self, state: GANState, audio, text, generator: torch.Generator | None = None,
               eps: torch.Tensor | None = None):
        """One critic update on a detached fake batch and a text batch.
        ``audio`` is a numpy ``Batch`` (or its device tensors), ``text`` a
        ``TextBatch``; ε from ``generator`` or ``eps``. Returns (state, aux:
        d_loss, wasserstein, gp)."""
        self.gen.train()
        db = audio if isinstance(audio, list) else self.to_device(audio)
        ids = torch.as_tensor(np.asarray(text[0]), dtype=torch.long).to(self.device)
        tlen = torch.as_tensor(np.asarray(text[1]), dtype=torch.long).to(self.device)
        with torch.no_grad():
            _, _, fake, fake_len, _ = self._gen_probs_full(state.g_params, db[0], db[1])
        d_fn = bce_d_loss_fn if self.cfg.gan.objective == "bce" else d_loss_fn
        params = _leaves(state.d_params)

        def disc(x, n):
            return functional_call(self.disc, params, (x, n))

        if generator is None and eps is None:
            generator = self.eps_generator(state.step, 0)
        loss, aux = d_fn(disc, self._real_dist(ids), tlen, fake, fake_len,
                         self.cfg.gan.lambda_gp, generator, eps)
        grads = torch.autograd.grad(loss, list(params.values()))
        updates, d_opt, _ = self.d_opt.update(dict(zip(params, grads)), state.d_opt, params)
        _apply_updates(params, updates)
        return state._replace(d_params=params, d_opt=d_opt), {k: v.detach()
                                                              for k, v in aux.items()}

    def g_step(self, state: GANState, audio, labeled=None):
        """One generator update through the critic: the GAN loss, the EODM
        term in the joint mode, the output regularisers, and the CTC mix-in
        (``gan.supervised_weight``) on ``labeled`` (or, outside the joint
        mode without a labeled stream, on the audio batch's own labels).
        Returns (state, aux)."""
        cfg = self.cfg
        self.gen.train()
        db = audio if isinstance(audio, list) else self.to_device(audio)
        params = _leaves(state.g_params)
        raw_p, raw_len, fake, fake_len, logits = self._gen_probs_full(params, db[0], db[1])
        g_fn = bce_g_loss_fn if cfg.gan.objective == "bce" else g_loss_fn
        g_l = g_fn(functional_call(self.disc, state.d_params, (fake, fake_len)))
        aux = {"g_loss": g_l}
        loss = g_l
        if self.tables is not None:
            e_l = cfg.eodm.weight * eodm_loss(logits, fake_len, self.tables,
                                              k_chunk=cfg.eodm.k_chunk)
            aux["eodm_loss"] = e_l
            loss = g_l + e_l
        loss = self._aux_penalties(fake, fake_len, aux, loss, raw_probs=raw_p, raw_len=raw_len)
        if cfg.gan.supervised_weight > 0:
            sup = None
            if labeled is not None:
                lab = labeled if isinstance(labeled, list) else self.to_device(labeled)
                sup = self._sup_ctc_term(params, lab)
            elif self.tables is None:
                # labels riding on the audio batches (synthetic ablations)
                sup = self._ctc(logits, fake_len, db[2], db[3])
            if sup is not None:
                aux["sup_ctc"] = sup
                loss = loss + cfg.gan.supervised_weight * sup
        grads = torch.autograd.grad(loss, list(params.values()))
        updates, g_opt, _ = self.g_opt.update(dict(zip(params, grads)), state.g_opt)
        _apply_updates(params, updates)
        return (state._replace(step=state.step + 1, g_params=params, g_opt=g_opt),
                {k: v.detach() for k, v in aux.items()})


class EODMTrainer(GeneratorBase):
    """Output-distribution matching: the generator's merged posteriors
    against the top-K n-gram tables of the unpaired text, built once on
    the host. Shares the generator pathway with ``GANTrainer``, so
    ``gan.segmenter``, ``gan.merge_repeats`` and the output regularisers
    apply here too."""

    def __init__(self, cfg: Config, text_sequences, device="cuda", centroids=None):
        self._init_generator(cfg, device, centroids)
        self.optimizer = make_optimizer(cfg)
        self.tables = device_ngram_tables(cfg.eodm, text_sequences, self.device)

    def init_state(self) -> TrainState:
        params = dict(self.gen.named_parameters())
        return TrainState(0, params, self.optimizer.init(params))

    def _loss(self, params, db):
        raw_p, raw_len, probs, out_len, logits = self._gen_probs_full(params, db[0], db[1])
        loss = self.cfg.eodm.weight * eodm_loss(logits, out_len, self.tables,
                                                k_chunk=self.cfg.eodm.k_chunk)
        aux = {"eodm_loss": loss}
        loss = self._aux_penalties(probs, out_len, aux, loss, raw_probs=raw_p, raw_len=raw_len)
        return loss, aux

    def train_step(self, state: TrainState, batch):
        """One update; returns (state, aux with ``eodm_loss`` and the
        penalties)."""
        self.gen.train()
        db = batch if isinstance(batch, list) else self.to_device(batch)
        params = _leaves(state.params)
        loss, aux = self._loss(params, db)
        grads = torch.autograd.grad(loss, list(params.values()))
        updates, opt_state, _ = self.optimizer.update(dict(zip(params, grads)), state.opt_state)
        _apply_updates(params, updates)
        return TrainState(state.step + 1, params, opt_state), {k: v.detach()
                                                               for k, v in aux.items()}


class GeneratorInfer(GeneratorBase):
    """The decode view of a GAN / EODM checkpoint: the chain it trained
    and was scored on (frontend -> optional segmentation -> classifier ->
    optional repeat merge) as ``logits_fn(audio, lengths) -> (logits,
    lengths)`` for ``run_inference``, on the weights ``self.gen`` holds."""

    def __init__(self, cfg: Config, device="cuda", centroids=None):
        self._init_generator(cfg, device, centroids)

    def logits_fn(self, audio: torch.Tensor, lengths: torch.Tensor):
        _, _, _, n, logits = self._gen_probs_full(None, audio, lengths)
        return logits, n


# -------------------------------------------------------------- loops


def run_ctc_training(
    cfg: Config,
    train_batches: Iterator[Batch],
    dev_batches_fn=None,
    trainer: CTCTrainer | None = None,
    state: TrainState | None = None,
    device="cuda",
) -> tuple[CTCTrainer, TrainState]:
    """Train, with periodic dev PER, periodic checkpoints and
    restore-latest resume. Runs on ``device`` (default CUDA; raises when
    no card is present rather than running on the CPU)."""
    trainer = trainer or CTCTrainer(cfg, device=device)
    writer = MetricWriter(cfg.model_dir, also_tensorboard=cfg.train.tensorboard)
    ckpt = CheckpointManager(f"{cfg.model_dir}/ckpt", max_to_keep=cfg.train.keep_checkpoints)
    if state is None:
        state = trainer.init_state()
        restored = ckpt.restore_latest(state)
        if restored is not None:
            state, start = restored
            log_stdout(start, "resume", restored_step=start)
    keeper = None
    if cfg.train.keep_best:
        if dev_batches_fn is None:
            raise ValueError(
                "train.keep_best is set but there is no dev split to score (set "
                "data.dev_list) — best-PER tracking would be silently inert")
        keeper = BestCheckpointKeeper(cfg.model_dir, higher_is_better=False)
    sync = torch.cuda.synchronize if trainer.device.type == "cuda" else (lambda *_: None)
    guard = PreemptionGuard()
    t0 = time.time()
    audio_sec_acc = 0.0
    for batch in train_batches:
        step = state.step
        if step >= cfg.train.total_steps or guard.triggered:
            if guard.triggered:
                log_stdout(step, "preempt", saving=1)
            break
        state, aux = trainer.train_step(state, batch)
        audio_sec_acc += float(np.sum(batch[1]) / cfg.frontend.sample_rate)
        step = state.step
        if step % cfg.train.log_every == 0:
            sync(trainer.device)
            dt = time.time() - t0
            loss = float(aux["loss"])
            writer.write(step, "train", loss=loss, grad_norm=float(aux["grad_norm"]),
                         audio_sec_per_sec=audio_sec_acc / max(dt, 1e-9))
            log_stdout(step, "train", loss=loss,
                       audio_sec_per_sec=audio_sec_acc / max(dt, 1e-9))
            t0, audio_sec_acc = time.time(), 0.0
        if dev_batches_fn and step % cfg.train.eval_every == 0:
            per = trainer.evaluate(state.params, dev_batches_fn())
            extra: dict[str, Any] = {}
            if keeper is not None and keeper.update(per, step, state):
                extra["dev_best"] = per
            writer.write(step, "dev", per=per, **extra)
            log_stdout(step, "dev", per=per, **extra)
            t0, audio_sec_acc = time.time(), 0.0
        if step % cfg.train.save_every == 0:
            ckpt.save(step, state)
    ckpt.save(state.step, state)
    guard.close()
    ckpt.close()
    if keeper is not None:
        keeper.close()
    writer.close()
    return trainer, state


def _selector(cfg: Config, dev_batches_fn):
    selector = UnsupSelector(cfg) if cfg.gan.select_lm_path else None
    if selector is not None and dev_batches_fn is None:
        raise ValueError(
            "gan.select_lm_path is set but there is no dev split to score (set "
            "data.dev_list) — selection would be silently inert")
    return selector


def _dev_eval(trainer: GeneratorBase, g_params, dev_batches_fn, selector, step, state) -> dict:
    """Dev PER and, with a selector, the label-free score (the best state
    kept under best_ckpt)."""
    dev = list(dev_batches_fn()) if selector is not None else dev_batches_fn()
    out = {"per": trainer.evaluate_per(g_params, dev)}
    if selector is not None:
        sel = selector.score(trainer, g_params, dev)
        out.update(unsup_score=sel["score"], unsup_lm_lp=sel["lm_logprob_per_token"],
                   unsup_usage_kl=sel["usage_kl"])
        if sel.get("coverage_kl") is not None:
            out["unsup_coverage_kl"] = sel["coverage_kl"]
        if selector.update(sel["score"], step, state):
            out["unsup_best"] = sel["score"]
    return out


def run_gan_training(
    cfg: Config,
    audio_batches: Iterator[Batch],
    text_sequences,
    with_eodm: bool = False,
    dev_batches_fn=None,
    labeled_batches: Iterator[Batch] | None = None,
    device="cuda",
) -> tuple[GANTrainer, GANState]:
    """The GAN alternation: ``gan.disc_steps`` critic steps (each on an
    audio and a text batch), then one generator step (with the EODM term
    when ``with_eodm``, and the CTC mix-in on ``labeled_batches``), with
    periodic dev PER, label-free selection (``gan.select_lm_path``),
    checkpoints and restore-latest resume."""
    from uasr_torch.data.dataset import text_batch_iterator

    device = resolve_device(device)
    tables = device_ngram_tables(cfg.eodm, text_sequences, device) if with_eodm else None
    trainer = GANTrainer(cfg, device=device, tables=tables)
    writer = MetricWriter(cfg.model_dir, also_tensorboard=cfg.train.tensorboard)
    ckpt = CheckpointManager(f"{cfg.model_dir}/ckpt", max_to_keep=cfg.train.keep_checkpoints)
    state = trainer.init_state()
    restored = ckpt.restore_latest(state)
    text_it = text_batch_iterator(text_sequences, cfg.data.batch_size, cfg.data.max_label_len,
                                  seed=cfg.train.seed)
    if restored is not None:
        state, start = restored
        # the text batches an unbroken run would have used by now
        text_it = itertools.islice(text_it, start * cfg.gan.disc_steps, None)
        log_stdout(start, "resume", restored_step=start)
    selector = _selector(cfg, dev_batches_fn)
    labeled_it = None
    if labeled_batches is not None:
        if cfg.gan.supervised_weight <= 0:
            raise ValueError(
                "labeled_batches provided but gan.supervised_weight is 0 — the "
                "semi-supervised mix-in would be silently inert")
        labeled_it = iter(labeled_batches)
    audio_it = iter(audio_batches)
    guard = PreemptionGuard()
    t0 = time.time()
    while state.step < cfg.train.total_steps and not guard.triggered:
        d_aux: dict = {}
        for k in range(cfg.gan.disc_steps):
            state, d_aux = trainer.d_step(state, next(audio_it), next(text_it),
                                          generator=trainer.eps_generator(state.step, k))
        lab = next(labeled_it) if labeled_it is not None else None
        state, g_aux = trainer.g_step(state, next(audio_it), lab)
        step = state.step
        if step % cfg.train.log_every == 0:
            scalars = {k: float(v) for k, v in {**d_aux, **g_aux}.items()}
            scalars["steps_per_sec"] = cfg.train.log_every / max(time.time() - t0, 1e-9)
            writer.write(step, "train", **scalars)
            log_stdout(step, "train", **scalars)
            t0 = time.time()
        if dev_batches_fn and step % cfg.train.eval_every == 0:
            res = _dev_eval(trainer, state.g_params, dev_batches_fn, selector, step, state)
            writer.write(step, "dev", **res)
            log_stdout(step, "dev", **res)
            t0 = time.time()
        if step % cfg.train.save_every == 0:
            ckpt.save(step, state)
    ckpt.save(state.step, state)
    guard.close()
    ckpt.close()
    if selector is not None:
        selector.close()
    writer.close()
    return trainer, state


def run_eodm_training(
    cfg: Config,
    audio_batches: Iterator[Batch],
    text_sequences,
    dev_batches_fn=None,
    device="cuda",
) -> tuple[EODMTrainer, TrainState]:
    """EODM training with periodic dev PER, label-free selection,
    checkpoints and restore-latest resume."""
    trainer = EODMTrainer(cfg, text_sequences, device=device)
    writer = MetricWriter(cfg.model_dir, also_tensorboard=cfg.train.tensorboard)
    ckpt = CheckpointManager(f"{cfg.model_dir}/ckpt", max_to_keep=cfg.train.keep_checkpoints)
    state = trainer.init_state()
    restored = ckpt.restore_latest(state)
    if restored is not None:
        state, start = restored
        log_stdout(start, "resume", restored_step=start)
    selector = _selector(cfg, dev_batches_fn)
    guard = PreemptionGuard()
    t0 = time.time()
    for batch in audio_batches:
        if state.step >= cfg.train.total_steps or guard.triggered:
            break
        state, aux = trainer.train_step(state, batch)
        step = state.step
        if step % cfg.train.log_every == 0:
            loss = float(aux["eodm_loss"])
            writer.write(step, "train", eodm_loss=loss,
                         steps_per_sec=cfg.train.log_every / max(time.time() - t0, 1e-9))
            log_stdout(step, "train", eodm_loss=loss)
            t0 = time.time()
        if dev_batches_fn and step % cfg.train.eval_every == 0:
            res = _dev_eval(trainer, state.params, dev_batches_fn, selector, step, state)
            writer.write(step, "dev", **res)
            log_stdout(step, "dev", **res)
            t0 = time.time()
        if step % cfg.train.save_every == 0:
            ckpt.save(step, state)
    ckpt.save(state.step, state)
    guard.close()
    ckpt.close()
    if selector is not None:
        selector.close()
    writer.close()
    return trainer, state
