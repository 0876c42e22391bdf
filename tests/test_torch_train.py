"""The port's training step against the JAX package on the CPU, and its
schedules, SpecAugment, checkpoints and the slices it refuses.

Whole step: a tiny conv_bigru (2 layers, H = 8, 16 mel bins, B = 4, f32,
SpecAugment off, constant lr 1e-3) from the same weights and numpy
batches; JAX's CTCTrainer runs flax's scan GRU and the scan CTC loss, the
port runs its kernel flags on CPU tensors (K2 / K2-bwd / K3 / K3-bwd's
plain versions). Bars: per-step loss and grad_norm rtol 1e-4, parameters
after step 3 atol 1e-4 (f32; the two differ in summation order only).
"""

import dataclasses
import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from uasr import train as jax_train
from uasr.config import Config as JaxConfig
from uasr.config import FrontendConfig as JaxFrontendConfig
from uasr.config import ModelConfig as JaxModelConfig
from uasr.config import TrainConfig as JaxTrainConfig
from uasr.data.dataset import Batch as JaxBatch
from uasr.frontend import specaugment as jax_specaug
from uasr_torch import config as tc
from uasr_torch import train
from uasr_torch.checkpoint import CheckpointManager, restore_averaged
from uasr_torch.convert import flax_to_state_dict
from uasr_torch.data.dataset import batch_iterator, make_synthetic_dataset
from uasr_torch.frontend import specaugment

MODEL = dict(encoder="conv_bigru", hidden_size=8, num_gru_layers=2, conv_channels=4)
LOSS_RTOL = 1e-4
PARAM_ATOL = 1e-4


def _batches(n, seed=0):
    examples, vocab = make_synthetic_dataset(num_utts=4 * n, num_phones=6, seed=seed)
    return list(itertools.islice(batch_iterator(examples, 4, 16000, 8, shuffle=False), n)), vocab


def _port_cfg(vocab_len, model_dir="exp/unused", **train_kw):
    return tc.Config(
        model_dir=model_dir,
        frontend=tc.FrontendConfig(num_mel_bins=16),
        model=tc.ModelConfig(gru_pallas=True, **MODEL),
        ctc=tc.CTCConfig(use_pallas=True),
        train=tc.TrainConfig(**{"lr": 1e-3, "lr_schedule": "constant", **train_kw}),
        vocab_size=vocab_len,
    )


def test_three_steps_match_jax_ctc_trainer():
    batches, vocab = _batches(3)
    jcfg = JaxConfig(frontend=JaxFrontendConfig(num_mel_bins=16), model=JaxModelConfig(**MODEL),
                     train=JaxTrainConfig(lr=1e-3, lr_schedule="constant", total_steps=3),
                     vocab_size=len(vocab))
    jtrainer = jax_train.CTCTrainer(jcfg)
    jstate = jtrainer.init_state(jax.random.PRNGKey(0), batches[0])
    init = jax.tree.map(np.asarray, jstate.params)

    trainer = train.CTCTrainer(_port_cfg(len(vocab)), device="cpu")
    trainer.model.load_state_dict(flax_to_state_dict(init, trainer.cfg))
    state = trainer.init_state()

    step_fn = jtrainer.jitted_train_step()
    rng = jax.random.PRNGKey(1)
    for b in batches:
        jstate, jaux = step_fn(jstate, JaxBatch(*map(jnp.asarray, b)), rng)
        state, aux = trainer.train_step(state, b)
        np.testing.assert_allclose(float(aux["loss"]), float(jaux["loss"]), rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(aux["grad_norm"]), float(jaux["grad_norm"]),
                                   rtol=LOSS_RTOL)
    assert state.step == 3 and int(jstate.step) == 3
    want = flax_to_state_dict(jax.tree.map(np.asarray, jstate.params), trainer.cfg)
    assert set(want) == set(state.params)
    for k, v in want.items():
        np.testing.assert_allclose(state.params[k].detach().numpy(), v.numpy(), atol=PARAM_ATOL,
                                   rtol=0, err_msg=k)


@pytest.mark.parametrize("schedule", ["constant", "warmup_rsqrt", "warmup_exp_decay"])
def test_schedules_match_jax(schedule):
    kw = dict(lr=6e-4, warmup_steps=200, lr_schedule=schedule, decay_rate=0.9, decay_steps=300)
    ours = train.make_schedule(tc.Config(train=tc.TrainConfig(**kw)))
    ref = jax_train.make_schedule(JaxConfig(train=JaxTrainConfig(**kw)))
    for step in (0, 1, 200, 2000):
        np.testing.assert_allclose(ours(step), float(ref(jnp.asarray(step, jnp.int32))),
                                   rtol=1e-6, err_msg=f"step {step}")


def test_clip_matches_optax_above_and_below_the_norm():
    """Gradient clip + Adam against optax on the same gradients: one
    update below the clip norm and one above it."""
    import optax

    rng = np.random.RandomState(0)
    grads = {"a": rng.randn(3, 4).astype(np.float32), "b": rng.randn(5).astype(np.float32)}
    cfg = tc.Config(train=tc.TrainConfig(lr=0.01, lr_schedule="warmup_rsqrt", warmup_steps=3,
                                         grad_clip=3.0))
    opt = train.make_optimizer(cfg)
    jopt = optax.chain(optax.clip_by_global_norm(3.0),
                       optax.adam(jax_train.make_schedule(
                           JaxConfig(train=JaxTrainConfig(lr=0.01, lr_schedule="warmup_rsqrt",
                                                          warmup_steps=3)))))
    params = {k: torch.zeros(v.shape) for k, v in grads.items()}
    ostate = opt.init(params)
    jstate = jopt.init({k: jnp.zeros(v.shape) for k, v in grads.items()})
    for scale in (0.1, 10.0):
        g = {k: v * scale for k, v in grads.items()}
        upd, ostate, norm = opt.update({k: torch.tensor(v) for k, v in g.items()}, ostate)
        jupd, jstate = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, jstate)
        np.testing.assert_allclose(float(norm), float(optax.global_norm(g)), rtol=1e-6)
        for k in g:
            np.testing.assert_allclose(upd[k].numpy(), np.asarray(jupd[k]), rtol=1e-5, atol=1e-9)


def test_spec_augment_masks_match_jax_formula(monkeypatch):
    """Given the same (width, start) per mask, the port's masks equal the
    JAX package's spec_augment; and the port's own draws stay in range."""
    B, T, D = 3, 30, 12
    fcfg = dict(specaug_freq_mask=4, specaug_freq_masks=2, specaug_time_mask=6,
                specaug_time_masks=2)
    rng = np.random.RandomState(0)
    feat = rng.randn(B, T, D).astype(np.float32)
    lengths = np.array([30, 17, 5])
    limits = [np.full(B, D)] * 2 + [np.maximum(lengths, 1)] * 2
    maxw = [4, 4, 6, 6]
    draws = []
    for lim, mw in zip(limits, maxw):
        w = rng.randint(0, mw + 1, B)
        draws.append((w, rng.randint(0, 1 << 20, B) % np.maximum(lim - w, 1)))
    seq = iter([a for w, s in draws for a in (w, s)])
    monkeypatch.setattr(jax_specaug.jax.random, "randint",
                        lambda key, shape, lo, hi: jnp.asarray(next(seq), jnp.int32))
    ref = jax_specaug.spec_augment(jax.random.PRNGKey(0), jnp.asarray(feat),
                                   jnp.asarray(lengths), JaxFrontendConfig(**fcfg))
    keep = torch.ones(B, T, D, dtype=torch.bool)
    for i, (w, s) in enumerate(draws):
        size = D if i < 2 else T
        m = specaugment.band_keep(size, torch.tensor(w), torch.tensor(s))
        keep &= m[:, None, :] if i < 2 else m[:, :, None]
    got = torch.where(keep, torch.tensor(feat), 0.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))

    gen = torch.Generator().manual_seed(3)
    limit = torch.tensor([30, 17, 5, 1])
    for _ in range(50):
        w, s = specaugment.draw_bands(gen, 4, 6, limit)
        assert ((w >= 0) & (w <= 6)).all()
        assert ((s >= 0) & (s < torch.clamp(limit - w, min=1))).all()
    out = specaugment.spec_augment(torch.Generator().manual_seed(1), torch.tensor(feat),
                                   torch.tensor(lengths), tc.FrontendConfig(**fcfg))
    assert out.shape == feat.shape and (out == 0).any()


def _state(value, step):
    return train.TrainState(step, {"w": torch.full((2, 3), float(value)),
                                   "n": torch.tensor([value], dtype=torch.long)},
                            {"count": step, "mu": {"w": torch.zeros(2, 3)}})


def test_checkpoints_keep_n_average_and_refuse_other_structures(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=3)
    for s in range(1, 6):
        mgr.save(s, _state(s, s))
    assert mgr.all_steps() == [3, 4, 5] and mgr.latest_step() == 5
    assert not list((tmp_path / "ckpt").glob("*.tmp"))
    got, step = mgr.restore_latest(_state(0, 0))
    assert step == 5 and got.step == 5 and float(got.params["w"][0, 0]) == 5.0
    avg, step = restore_averaged(mgr, _state(0, 0), 2)
    assert step == 5 and got.opt_state["count"] == 5
    assert torch.equal(avg.params["w"], torch.full((2, 3), 4.5))
    assert int(avg.params["n"]) == 5  # integer leaves come from the newest
    bad = train.TrainState(0, {"w": torch.zeros(3, 3), "n": torch.tensor([0])},
                           {"count": 0, "mu": {"w": torch.zeros(2, 3)}})
    with pytest.raises(ValueError, match="different state structure"):
        mgr.restore_latest(bad)
    assert CheckpointManager(str(tmp_path / "empty")).restore_latest(_state(0, 0)) is None


def test_resume_matches_unbroken_run_bit_for_bit(tmp_path):
    """2 steps, save, resume in a new trainer for 2 more == 4 straight
    steps, with SpecAugment on (its draws depend on (seed, step))."""
    batches, vocab = _batches(4, seed=5)
    kw = dict(save_every=1000, log_every=1000, eval_every=1000)
    fcfg = tc.FrontendConfig(num_mel_bins=16, specaug_freq_mask=3, specaug_freq_masks=2,
                             specaug_time_mask=4, specaug_time_masks=1)

    def run(model_dir, total, data):
        cfg = dataclasses.replace(_port_cfg(len(vocab), str(model_dir), total_steps=total, **kw),
                                  frontend=fcfg)
        return train.run_ctc_training(cfg, iter(data), device="cpu")[1]

    straight = run(tmp_path / "a", 4, batches)
    run(tmp_path / "b", 2, batches[:2])
    resumed = run(tmp_path / "b", 4, batches[2:])
    assert straight.step == resumed.step == 4
    assert CheckpointManager(str(tmp_path / "b" / "ckpt")).all_steps() == [2, 4]
    for k, v in straight.params.items():
        assert torch.equal(v, resumed.params[k]), k
    for k, v in straight.opt_state["nu"].items():
        assert torch.equal(v, resumed.opt_state["nu"][k]), k


def test_dropout_acts_in_train_mode_only():
    from uasr_torch.models.models import build_model

    cfg = tc.ModelConfig(dropout=0.5, **MODEL)
    model = build_model(cfg, 5, 16, device="cpu")
    x, n = torch.randn(2, 20, 16), torch.tensor([20, 11])
    with torch.no_grad():
        a, b = model(x, n)[0], model(x, n)[0]
        model.train()
        c = model(x, n)[0]
    assert not model.cfg.gru_pallas and torch.equal(a, b) and not torch.equal(a, c)


@pytest.mark.parametrize("change,match", [
    (dict(train=dict(mode="frame_ce")), "slice 3"),
    (dict(train=dict(mode="ssl")), "item 10"),
    (dict(train=dict(grad_accum=2)), "slice 5"),
    (dict(parallel=dict(model_parallel=2)), "slice 5"),
])
def test_unported_training_options_raise(change, match):
    cfg = _port_cfg(8)
    for section, kw in change.items():
        cfg = dataclasses.replace(cfg, **{section: dataclasses.replace(getattr(cfg, section),
                                                                       **kw)})
    with pytest.raises(NotImplementedError, match=match):
        train.CTCTrainer(cfg, device="cpu")


def test_feature_batches_raise_and_cuda_needs_a_card():
    trainer = train.CTCTrainer(_port_cfg(8), device="cpu")
    feats = (np.zeros((2, 10, 16), np.float32), np.array([10, 4]), np.zeros((2, 3), np.int32),
             np.array([3, 1]))
    with pytest.raises(NotImplementedError, match="item 10"):
        trainer.train_step(trainer.init_state(), feats)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device does not raise")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.CTCTrainer(_port_cfg(8))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.run_ctc_training(_port_cfg(8), iter([feats]))


@pytest.mark.parametrize("kw", [dict(), dict(syntax="markov", num_phones=8),
                                dict(style="formant", syntax="markov", num_phones=39)],
                         ids=["tone_iid", "tone_markov", "formant_markov"])
def test_data_layer_matches_jax(kw):
    """The port's copy of the synthetic corpora and of bucketed batching
    gives the JAX package's examples and batches exactly."""
    from uasr.data import dataset as jds
    from uasr_torch.data import dataset as tds

    ours, vocab = tds.make_synthetic_dataset(num_utts=12, seed=4, **kw)
    ref, jvocab = jds.make_synthetic_dataset(num_utts=12, seed=4, **kw)
    assert vocab.tokens == jvocab.tokens
    for (a, ids), (ja, jids) in zip(ours, ref):
        np.testing.assert_array_equal(a, ja)
        assert ids == jids
    args = dict(batch_size=3, max_audio_samples=32000, max_label_len=9, seed=1, num_epochs=2,
                drop_remainder=False, bucket_boundaries=(16000, 24000))
    for b, jb in itertools.zip_longest(tds.batch_iterator(ours, **args),
                                       jds.batch_iterator(ref, **args)):
        for x, y in zip(b, jb):
            np.testing.assert_array_equal(x, y)


def test_prefetch_reraises_worker_errors():
    from uasr_torch.data.dataset import prefetch

    def bad():
        yield 1
        raise ValueError("bad wav")

    it = prefetch(bad())
    assert next(it) == 1
    with pytest.raises(ValueError, match="bad wav"):
        next(it)


def test_dev_eval_keeps_the_best_checkpoint(tmp_path):
    """run_ctc_training with a dev split: PER logged at eval_every, the best
    checkpoint committed under best_ckpt with its score; keep_best without
    a dev split raises."""
    import json

    batches, vocab = _batches(2, seed=6)
    cfg = _port_cfg(len(vocab), str(tmp_path), total_steps=2, eval_every=1, keep_best=True,
                    log_every=1, save_every=1000)
    _, state = train.run_ctc_training(cfg, iter(batches), dev_batches_fn=lambda: iter(batches),
                                      device="cpu")
    recs = [json.loads(ln) for ln in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    dev = [r for r in recs if r["tag"] == "dev"]
    assert [r["step"] for r in dev] == [1, 2] and all(0 <= r["per"] for r in dev)
    score = json.loads((tmp_path / "best_ckpt" / "score.json").read_text())
    assert score["score"] == min(r["per"] for r in dev)
    assert CheckpointManager(str(tmp_path / "best_ckpt")).all_steps() == [score["step"]]
    with pytest.raises(ValueError, match="no dev split"):
        train.run_ctc_training(cfg, iter(batches), device="cpu")


def test_preemption_guard_stops_after_the_current_step(tmp_path, monkeypatch):
    """A SIGTERM during a step: the loop finishes that step, saves it and
    stops."""
    import signal

    guards = []

    class Recording(train.PreemptionGuard):
        def __init__(self):
            super().__init__()
            guards.append(self)

    monkeypatch.setattr(train, "PreemptionGuard", Recording)
    batches, vocab = _batches(3, seed=7)
    cfg = _port_cfg(len(vocab), str(tmp_path), total_steps=3, save_every=1000, log_every=1000)
    trainer = train.CTCTrainer(cfg, device="cpu")
    real_step = trainer.train_step

    def step_then_signal(state, batch):
        out = real_step(state, batch)
        guards[-1]._handle(signal.SIGTERM, None)
        return out

    trainer.train_step = step_then_signal
    _, state = train.run_ctc_training(cfg, iter(batches), trainer=trainer)
    assert state.step == 1
    assert CheckpointManager(str(tmp_path / "ckpt")).all_steps() == [1]
