"""Self-supervised pretraining (``train.mode: ssl``; counterpart of
``uasr.pretrain``): CPC / wav2vec-style contrastive pretraining over raw
unlabeled audio, on the port's loader, checkpoints, preemption guard and
metric writer. Its products are a checkpoint under ``model_dir/ckpt`` and
the features ``uasr_torch.tools.featurize`` dumps from it into the cache
the GAN / EODM trainers read (``data.feature_cache``).

One step: (with ``ssl.input_type: fbank`` the log-mel frontend, K1 on the
card) -> the conv encoder -> the causal GRU context (K5 forward and K5-bwd
backward on the card with ``ssl.context_pallas``) -> the K prediction
heads -> InfoNCE over sampled in-utterance negatives (or the fused chunked
loss) -> global-norm clip -> Adam, on one device or over a mesh (each
rank on its rows of the global batch, the loss and the negatives the
global batch's, as ``uasr_torch.train`` describes).

The negatives come from a ``torch.Generator`` seeded by (train.seed,
step), so a resumed run draws what an unbroken one would; dev evaluation
draws every batch's from seed 0, as JAX's ``evaluate`` uses
``PRNGKey(0)``. JAX splits one ``jax.random`` key (ROADMAP.md,
"Deliberate divergences").
"""

from __future__ import annotations

import time
from typing import Iterator

import torch

from uasr_torch import resolve_device
from uasr_torch.config import Config
from uasr_torch.frontend.features import compute_features, frontend_state_from_config
from uasr_torch.models.ssl import build_cpc_model
from uasr_torch.ops.infonce import info_nce_loss, info_nce_loss_fused, sample_negatives
from uasr_torch.parallel import collectives as C
from uasr_torch.parallel.mesh import Mesh, shard_batch
from uasr_torch.train import (
    PreemptionGuard, RunIO, TrainState, _apply, _audio_seconds, _check_mesh,
    _leaves, _OnMesh, _shard, _sum_grads, _to_device, make_optimizer,
)


class SSLTrainer(_OnMesh):
    """Contrastive pretraining on one device or a mesh, with the
    ``TrainState`` and checkpoint contract of the CTC trainer."""

    def __init__(self, cfg: Config, device="cuda", mesh: Mesh | None = None):
        _check_mesh(cfg, mesh)
        self.cfg, self.mesh = cfg, mesh
        self.device = resolve_device(device)
        dt = torch.bfloat16 if cfg.model.dtype == "bfloat16" else torch.float32
        self.model = build_cpc_model(cfg.ssl, dt, cfg.frontend.dim_input,
                                     generator=torch.Generator().manual_seed(cfg.train.seed),
                                     device=self.device)
        self.plans = (_shard(self.model, mesh), None)
        self.optimizer = make_optimizer(cfg)
        self.optimizer.plan = self.plans[0]
        self._frontend_state = None

    @property
    def frontend_state(self):
        if self._frontend_state is None:
            self._frontend_state = frontend_state_from_config(self.cfg.frontend,
                                                              device=self.device)
        return self._frontend_state

    def to_device(self, batch) -> list[torch.Tensor]:
        return _to_device(batch, self.device)

    def step_generator(self, step: int) -> torch.Generator:
        """The negatives' random stream for ``step``: a function of
        (train.seed, step)."""
        return torch.Generator().manual_seed(self.cfg.train.seed * 1_000_003 + int(step))

    def _inputs(self, audio: torch.Tensor, lengths: torch.Tensor):
        """Raw samples for ``input_type: waveform``; log-mel frames (K1 on
        the card) for ``fbank``, unless the batch already holds frames."""
        if self.cfg.ssl.input_type != "fbank" or audio.ndim == 3:
            return audio, lengths
        with torch.no_grad():  # the frontend has no parameters
            return compute_features(audio, lengths, self.frontend_state, self.cfg.frontend)

    def encode(self, params, audio: torch.Tensor, lengths: torch.Tensor):
        """(z, c, preds, frame lengths) for the configured input type, on
        ``params`` (the model's own weights when None): the one entry point
        of the loss and of ``tools.featurize``."""
        x, xl = self._inputs(audio, lengths)
        return _apply(self.model, params, x, xl)

    def init_state(self) -> TrainState:
        params = dict(self.model.named_parameters())
        return TrainState(0, params, self.optimizer.init(params))

    def _loss(self, params: dict, db: list[torch.Tensor], generator: torch.Generator):
        ssl = self.cfg.ssl
        z, c, preds, flen = self.encode(params, db[0], db[1])
        neg = (sample_negatives(generator, flen, ssl.num_negatives)
               if ssl.num_negatives > 0 else None)
        if ssl.fused_loss:
            heads = params["heads.weight"]
            if self.plans[0] is not None and "heads.weight" in self.plans[0].dims:
                heads = C.gather(heads, 0, self.mesh.model_group)  # the loss reads it whole
            loss, acc = info_nce_loss_fused(c, heads, params["heads.bias"], z,
                                            flen, num_steps=ssl.predict_steps,
                                            temperature=ssl.temperature, neg_indices=neg,
                                            chunk=ssl.loss_chunk)
        else:
            loss, acc = info_nce_loss(preds, z, flen, temperature=ssl.temperature,
                                      neg_indices=neg)
        return loss, {"nce_loss": loss.detach(), "nce_acc": acc.detach()}

    def loss_and_grads(self, params: dict, batch, generator: torch.Generator):
        """(aux, grads) of the InfoNCE loss at ``params``; ``batch`` is a
        numpy ``Batch`` or its tensors on the device."""
        self.model.train()
        params = _leaves(params)
        db = batch if isinstance(batch, list) else self.to_device(batch)
        with C.active(self.mesh):
            loss, aux = self._loss(params, db, generator)
            grads = torch.autograd.grad(loss, list(params.values()))
        return aux, _sum_grads(self.mesh, dict(zip(params, grads)))

    def train_step(self, state: TrainState, batch, generator: torch.Generator | None = None):
        """One update. Returns (new state, aux: ``nce_loss``, ``nce_acc`` and
        ``grad_norm``, the norm before the clip, as 0-d device tensors)."""
        aux, grads = self.loss_and_grads(state.params, batch,
                                         generator or self.step_generator(state.step))
        opt_state, g_norm = self.optimizer.update(grads, state.opt_state, state.params)
        aux["grad_norm"] = g_norm
        return TrainState(state.step + 1, state.params, opt_state), aux

    @torch.no_grad()
    def eval_step(self, params: dict, batch, generator: torch.Generator):
        """(nce_loss, nce_acc) of one batch (on a mesh, this rank's rows of
        it; the values are the batch's)."""
        self.model.eval()
        with C.active(self.mesh):
            loss, aux = self._loss(params, self.to_device(batch), generator)
        return loss, aux["nce_acc"]

    def evaluate(self, params: dict, batches) -> tuple[float, float]:
        """Mean (nce_loss, nce_acc) over dev batches, each batch's negatives
        drawn from seed 0, so evals are comparable across steps. On a mesh
        a ragged batch is zero-padded to split evenly (empty rows add
        nothing to InfoNCE's global sums)."""
        tot_l = tot_a = n = 0.0
        for b in batches:
            loss, acc = self.eval_step(params, self.eval_rows(b),
                                       torch.Generator().manual_seed(0))
            tot_l += float(loss)
            tot_a += float(acc)
            n += 1
        return tot_l / max(n, 1), tot_a / max(n, 1)


def run_ssl_pretraining(cfg: Config, train_batches: Iterator, dev_batches_fn=None,
                        device="cuda", mesh: Mesh | None = None) -> tuple[SSLTrainer, TrainState]:
    """Pretrain with the framework's contract: logging every
    ``train.log_every``, dev eval, keep-N checkpoints, restore-latest
    resume and a preemption-safe save. Runs on ``device`` (default CUDA;
    raises when no card is present), over ``mesh`` when given."""
    trainer = SSLTrainer(cfg, device=device, mesh=mesh)
    io = RunIO(cfg, trainer)
    state = trainer.init_state()
    restored = io.restore_latest(state)
    if restored is not None:
        state, start = restored
        io.log(start, "resume", restored_step=start)
    sync = torch.cuda.synchronize if trainer.device.type == "cuda" else (lambda *_: None)
    guard = PreemptionGuard()
    t0 = time.time()
    audio_sec_acc = 0.0
    for batch in train_batches:
        step = state.step
        if step >= cfg.train.total_steps or guard.triggered:
            if guard.triggered:
                io.log(step, "preempt", saving=1)
            break
        state, aux = trainer.train_step(state, shard_batch(batch, mesh))
        audio_sec_acc += _audio_seconds(cfg, batch)
        step = state.step
        if step % cfg.train.log_every == 0:
            sync(trainer.device)
            rate = audio_sec_acc / max(time.time() - t0, 1e-9)
            scalars = {k: float(aux[k]) for k in ("nce_loss", "nce_acc")}
            io.write(step, "train", **scalars, grad_norm=float(aux["grad_norm"]),
                     audio_sec_per_sec=rate)
            io.log(step, "train", **scalars, audio_sec_per_sec=rate)
            t0, audio_sec_acc = time.time(), 0.0
        if dev_batches_fn and step % cfg.train.eval_every == 0:
            dl, da = trainer.evaluate(state.params, dev_batches_fn())
            io.write(step, "dev", nce_loss=dl, nce_acc=da)
            io.log(step, "dev", nce_loss=dl, nce_acc=da)
            t0, audio_sec_acc = time.time(), 0.0
        if step % cfg.train.save_every == 0:
            io.save(step, state)
    io.save(state.step, state)
    guard.close()
    io.close()
    return trainer, state

