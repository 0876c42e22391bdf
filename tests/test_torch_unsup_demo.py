"""The 600-step unsupervised demo (configs/synthetic_unsup_demo.yaml) in
the port from the JAX package's own initial weights and interpolation
draws, against the JAX package's run of the same recipe, on the CPU
(~8 min; marked slow like tests/test_unsup_integration.py, whose demo
run this mirrors).

The GAN alternation is chaotic near the permutation it discovers: JAX's
own runs of the recipe land at dev PER 0.39-0.55 from thread timing
alone (tests/test_unsup_integration.py). Given JAX's init and draws the
port follows JAX's trajectory, so both must land below the recipe's
0.65 bar and within 0.05 of each other at every dev evaluation."""

import itertools
import json
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from uasr import train as jax_train
from uasr.config import load_config as jax_load_config
from uasr.data.dataset import Batch as JaxBatch
from uasr.data.dataset import TextBatch as JaxTextBatch
from uasr_torch import cli, train
from uasr_torch.config import load_config
from uasr_torch.convert import critic_to_state_dict, flax_to_state_dict
from uasr_torch.data.dataset import text_batch_iterator
from uasr_torch.ops.eodm import device_ngram_tables

RECIPE = str(pathlib.Path(__file__).resolve().parents[1] / "configs" / "synthetic_unsup_demo.yaml")


@pytest.mark.slow
def test_demo_from_jax_init_tracks_jax(tmp_path):
    cfg, jcfg = load_config(RECIPE), jax_load_config(RECIPE)
    jcfg.model_dir = cfg.model_dir = str(tmp_path)
    source, _ = cli._load_source(cfg, "train")
    text = [ids for _, ids in source[1] if ids]
    dev = cli._dev_batches_fn(cfg)
    B, k = cfg.data.batch_size, cfg.gan.disc_steps

    # JAX: its run_gan_training as `--mode train` runs it, dev PER every 200
    jax_train.run_gan_training(jcfg, cli._batches(cfg, source, seed=cfg.train.seed), text,
                               with_eodm=True, dev_batches_fn=dev)
    recs = [json.loads(ln) for ln in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    pers = {r["step"]: [r["per"]] for r in recs if r["tag"] == "dev"}

    # the port from the same initial weights, batches and interpolation draws
    audio = cli._batches(cfg, source, seed=cfg.train.seed)
    text_it = text_batch_iterator(text, B, cfg.data.max_label_len, seed=cfg.train.seed)
    first_a, first_t = next(audio), next(text_it)
    init = jax_train.GANTrainer(jcfg).init_state(
        jax.random.PRNGKey(cfg.train.seed), JaxBatch(*map(jnp.asarray, first_a)),
        JaxTextBatch(*map(jnp.asarray, first_t)))
    init = jax.tree.map(np.asarray, init)
    audio, text_it = itertools.chain([first_a], audio), itertools.chain([first_t], text_it)
    trainer = train.GANTrainer(cfg, device="cpu", tables=device_ngram_tables(cfg.eodm, text))
    trainer.gen.load_state_dict(flax_to_state_dict(init.g_params, cfg))
    trainer.disc.load_state_dict(critic_to_state_dict(init.d_params, cfg))
    state = trainer.init_state()
    rng = jax.random.PRNGKey(cfg.train.seed)
    while state.step < cfg.train.total_steps:
        for _ in range(k):
            rng, sub = jax.random.split(rng)
            eps = torch.tensor(np.asarray(jax.random.uniform(sub, (B, 1, 1), jnp.float32)))
            state, _ = trainer.d_step(state, next(audio), next(text_it), eps=eps)
        rng, _ = jax.random.split(rng)
        state, _ = trainer.g_step(state, next(audio))
        if state.step % cfg.train.eval_every == 0:
            pers[state.step].append(trainer.evaluate_per(state.g_params, dev()))
    print({s: [round(p, 4) for p in v] for s, v in sorted(pers.items())})
    assert sorted(pers) == [200, 400, 600]
    for step, (want, got) in sorted(pers.items()):
        assert abs(got - want) <= 0.05, (step, got, want)
    assert max(pers[600]) < 0.65
