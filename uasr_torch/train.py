"""Supervised CTC training (counterpart of ``uasr.train``'s optimizer,
``CTCTrainer``, checkpoint keepers and ``run_ctc_training``).

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

Divergences, recorded in ROADMAP.md: random streams differ (SpecAugment
draws from a ``torch.Generator`` seeded by (train.seed, step), so a
resumed run draws what an unbroken one would; JAX splits one
``jax.random`` key); dropout (``model.dropout``) acts in training here,
while JAX's ``CTCTrainer`` never passes flax a dropout key.

Not ported yet, each raising ``NotImplementedError`` that names its slice:
``train.mode: frame_ce``, ``grad_accum > 1``, meshes and several devices,
and batches of precomputed 3-D features.
"""

from __future__ import annotations

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
from uasr_torch.models.models import build_model
from uasr_torch.ops.ctc import ctc_loss
from uasr_torch.ops.cuda_ctc import ctc_loss_kernel
from uasr_torch.ops.decode import ctc_beam_search_decode, ctc_greedy_decode
from uasr_torch.ops.edit_distance import batch_edit_distance


class TrainState(NamedTuple):
    step: int
    params: dict  # name -> f32 tensor (leaf, requires grad)
    opt_state: dict  # {"count": int, "mu": {name: tensor}, "nu": {name: tensor}}


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
    eps))`` on dicts of tensors; ``update`` also returns the unclipped
    global norm."""

    def __init__(self, schedule, max_norm: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.schedule, self.max_norm = schedule, max_norm
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params: dict) -> dict:
        return {"count": 0,
                "mu": {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()},
                "nu": {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}}

    @torch.no_grad()
    def update(self, grads: dict, opt_state: dict):
        """(updates, new opt_state, unclipped global norm). The moments are
        updated in place."""
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


def make_optimizer(cfg: Config) -> ClipAdam:
    """Global-norm clip at ``train.grad_clip``, then Adam on the schedule."""
    if cfg.train.grad_accum > 1:
        raise NotImplementedError(
            "train.grad_accum > 1 is not ported yet (ROADMAP.md Queue 1, slice 5: scale)")
    return ClipAdam(make_schedule(cfg), cfg.train.grad_clip)


# ---------------------------------------------------------- CTC trainer


class CTCTrainer:
    """Supervised CTC training and eval on one device."""

    def __init__(self, cfg: Config, device="cuda"):
        if cfg.train.mode == "frame_ce":
            raise NotImplementedError(
                "train.mode frame_ce is not ported yet (ROADMAP.md Queue 1, slice 3: frame-CE)")
        if cfg.train.mode != "ctc":
            raise NotImplementedError(
                f"train.mode {cfg.train.mode!r} is not ported yet (ROADMAP.md Queue 1, "
                "slice 4: unsupervised training and SSL)")
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
        b = Batch(*(np.asarray(x) for x in batch[:4]))
        if b.audio.ndim == 3:
            raise NotImplementedError(
                "batches of precomputed [B, T, D] features are not ported yet (ROADMAP.md "
                "Queue 1, slice 4: unsupervised training and SSL)")
        return [torch.as_tensor(b.audio, dtype=torch.float32).to(self.device)] + [
            torch.as_tensor(x, dtype=torch.long).to(self.device) for x in b[1:]]

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
        params = {k: p if p.requires_grad else p.requires_grad_() for k, p in params.items()}
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
        with torch.no_grad():
            for k, u in updates.items():
                state.params[k].add_(u)
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


# -------------------------------------------------------------- loop


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
