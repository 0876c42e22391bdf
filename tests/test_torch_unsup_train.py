"""The port's unsupervised training on the CPU against the JAX package:
three GAN alternations (critic steps, then a generator step) with the
joint EODM term and the repeat merge under the bce objective, and with
the semi-supervised CTC mix-in under WGAN-GP; three EODM steps.

Tiny sizes (tests/_torch_unsup_cases.py: classifier hidden 24, critic 16
x 2, V = 8, B = 8, 16 mel bins, 1 s of audio at downsample 3: T <= 34),
f32, from the same weights and numpy batches. The bce case holds the
port's GANTrainer, fed JAX's interpolation draws, against the JAX
package's whole run_gan_training (its logged losses and final state); the
WGAN-GP case steps from JAX's own state at every step (see
``_teacher_forced_wgan``). Bars: d_loss, gp, g_loss, eodm_loss per step
rtol 1e-4 (atol 1e-7 where a value is near zero), both nets' parameters
after three steps atol 1e-4."""

import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests._torch_unsup_cases import B, CASES, batches, cfgs, corpus
from uasr import train as jax_train
from uasr.data.dataset import Batch as JaxBatch
from uasr.data.dataset import TextBatch as JaxTextBatch
from uasr_torch import train
from uasr_torch.convert import critic_to_state_dict, flax_to_state_dict
from uasr_torch.data.dataset import text_batch_iterator
from uasr_torch.ops.eodm import device_ngram_tables


def _jax_eps(seed, steps, disc_steps):
    """The interpolation draws of JAX's run_gan_training: one split of the
    run's key per critic step and per generator step."""
    rng, out = jax.random.PRNGKey(seed), []
    for _ in range(steps):
        for _ in range(disc_steps):
            rng, sub = jax.random.split(rng)
            out.append(np.asarray(jax.random.uniform(sub, (B, 1, 1), dtype=jnp.float32)))
        rng, _ = jax.random.split(rng)
    return out


@pytest.fixture(scope="module", params=sorted(CASES))
def gan_run(request, tmp_path_factory):
    """The inputs of three alternations and JAX's initial state; for the
    bce case also JAX's run_gan_training over them: its per-step metrics
    and final state."""
    case = request.param
    with_eodm = CASES[case][2]
    examples, vocab = corpus()
    jc, pc = cfgs(case, tmp_path_factory.mktemp(case), len(vocab))
    audio = batches(examples, 3 * (jc.gan.disc_steps + 1))
    text = [ids for _, ids in examples]
    labeled = batches(examples[:8], 3, seed=1) if not with_eodm else None
    init = jax_train.GANTrainer(jc).init_state(
        jax.random.PRNGKey(jc.train.seed), JaxBatch(*map(jnp.asarray, audio[0])),
        JaxTextBatch(*map(jnp.asarray, next(text_batch_iterator(text, B, 8, seed=0)))))
    run = dict(case=case, jc=jc, pc=pc, audio=audio, text=text, labeled=labeled,
               init=jax.tree.map(np.asarray, init), with_eodm=with_eodm)
    if with_eodm:
        _, jstate = jax_train.run_gan_training(jc, iter(audio), text, with_eodm=True)
        run["final"] = jax.tree.map(np.asarray, jstate)
        run["recs"] = [json.loads(ln) for ln in (pathlib.Path(jc.model_dir) / "metrics.jsonl")
                       .read_text().splitlines()]
    return run


def _port_gan(run):
    pc = run["pc"]
    tables = device_ngram_tables(pc.eodm, run["text"], "cpu") if run["with_eodm"] else None
    trainer = train.GANTrainer(pc, device="cpu", tables=tables)
    trainer.gen.load_state_dict(flax_to_state_dict(run["init"].g_params, pc))
    trainer.disc.load_state_dict(critic_to_state_dict(run["init"].d_params, pc))
    return trainer


def _compare_params(ours: dict, ref: dict, noise=(), bound=0.0):
    assert set(ours) == set(ref)
    for name, v in ref.items():
        o = ours[name].detach()
        if name in noise:  # rounding-floor entries: at most an Adam step apart
            o, v = o[~noise[name]], v[~noise[name]]
            assert float((ours[name].detach() - ref[name]).abs().max()) <= bound, name
        np.testing.assert_allclose(o.numpy(), v.numpy(), rtol=0, atol=1e-4, err_msg=name)


def test_three_gan_alternations_match_jax(gan_run):
    """bce + EODM: the port's steps against JAX's whole run_gan_training
    (its logged losses and final state); WGAN-GP + the CTC mix-in: each
    step from JAX's own state."""
    if not gan_run["with_eodm"]:
        _teacher_forced_wgan(gan_run)
        return
    pc = gan_run["pc"]
    trainer = _port_gan(gan_run)
    state = trainer.init_state()
    audio, k = iter(gan_run["audio"]), pc.gan.disc_steps
    text_it = text_batch_iterator(gan_run["text"], B, 8, seed=pc.train.seed)
    eps = iter(_jax_eps(pc.train.seed, 3, k))
    for rec in gan_run["recs"]:
        for _ in range(k):
            state, d_aux = trainer.d_step(state, next(audio), next(text_it),
                                          eps=torch.tensor(next(eps)))
        state, g_aux = trainer.g_step(state, next(audio))
        assert rec["step"] == state.step
        want = ["d_loss", "wasserstein", "gp", "g_loss", "eodm_loss", "g_entropy",
                "g_diversity", "g_smooth"]
        got = {**d_aux, **g_aux}
        assert set(got) == set(want) and set(rec) >= set(want)
        for name in want:
            np.testing.assert_allclose(float(got[name]), rec[name], rtol=1e-4, atol=1e-7,
                                       err_msg=f"{name} @ step {state.step}")
    assert state.step == 3
    final = gan_run["final"]
    _compare_params(state.g_params, flax_to_state_dict(final.g_params, pc))
    _compare_params(state.d_params, critic_to_state_dict(final.d_params, pc))


def _adam(opt_state):
    """optax's ScaleByAdamState inside a chain's state."""
    leaves = jax.tree_util.tree_leaves(opt_state, is_leaf=lambda x: hasattr(x, "mu"))
    return next(x for x in leaves if hasattr(x, "mu"))


def _port_state(js, pc) -> train.GANState:
    """A JAX GANState (numpy leaves) as the port's: both trees, and each
    optimizer's count and Adam moments through the same bridges."""
    conv = {"g": flax_to_state_dict, "d": critic_to_state_dict}

    def opt(tree, side):
        a = _adam(tree)
        return {"count": int(a.count), "mu": conv[side](a.mu, pc), "nu": conv[side](a.nu, pc)}

    return train.GANState(int(js.step), flax_to_state_dict(js.g_params, pc),
                          critic_to_state_dict(js.d_params, pc), opt(js.g_opt, "g"),
                          opt(js.d_opt, "d"))


def _teacher_forced_wgan(run):
    """WGAN-GP + the CTC mix-in, each of the three alternations' steps from
    JAX's own state (JAX's jitted d_step and g_step, the draws of
    run_gan_training). A critic unit active on every sample of both batches
    has a Wasserstein gradient that is zero but for rounding (the real and
    fake terms cancel; JAX's sum lands on 0.0, the port's on ~2e-9), and
    Adam turns that into a step of up to ~lr: such entries (first moment
    under 1e-6 of the largest on both sides) are held to 3 lr, every other
    entry and every loss to the bars. Chaining the steps instead would
    carry that noise into the next losses."""
    pc = run["pc"]
    trainer = _port_gan(run)
    jtr = jax_train.GANTrainer(run["jc"])
    jtr.frontend_state  # built eagerly: a lazy build inside jit leaks a tracer
    jd, jg = jax.jit(jtr.d_step), jax.jit(jtr.g_step)
    js = jax.tree.map(jnp.asarray, run["init"])
    audio, k = iter(run["audio"]), pc.gan.disc_steps
    text_it = text_batch_iterator(run["text"], B, 8, seed=pc.train.seed)
    labeled = iter(run["labeled"])
    rng = jax.random.PRNGKey(pc.train.seed)

    def check(aux, jaux, new, js_new, side, lr):
        assert set(aux) == set(jaux)
        for name, v in jaux.items():
            np.testing.assert_allclose(float(aux[name]), float(v), rtol=1e-4, atol=1e-7,
                                       err_msg=f"{name} @ step {int(js.step)}")
        ref = _port_state(jax.tree.map(np.asarray, js_new), pc)
        ours, theirs = getattr(new, f"{side}_params"), getattr(ref, f"{side}_params")
        mu_o, mu_r = getattr(new, f"{side}_opt")["mu"], getattr(ref, f"{side}_opt")["mu"]
        top = max(float(m.abs().max()) for m in mu_r.values())
        noise = {n: (mu_r[n].abs() <= 1e-6 * top) & (mu_o[n].abs() <= 1e-6 * top)
                 for n in mu_r}
        _compare_params(ours, theirs, noise, 3 * lr)

    for _ in range(3):
        for _ in range(k):
            rng, sub = jax.random.split(rng)
            a, t = next(audio), next(text_it)
            eps = np.asarray(jax.random.uniform(sub, (B, 1, 1), dtype=jnp.float32))
            new, aux = trainer.d_step(_port_state(jax.tree.map(np.asarray, js), pc), a, t,
                                      eps=torch.tensor(eps))
            js_new, jaux = jd(js, JaxBatch(*map(jnp.asarray, a)), JaxTextBatch(
                *map(jnp.asarray, t)), sub)
            check(aux, jaux, new, js_new, "d", pc.gan.d_lr)
            js = js_new
        rng, sub = jax.random.split(rng)
        a, lab = next(audio), next(labeled)
        new, aux = trainer.g_step(_port_state(jax.tree.map(np.asarray, js), pc), a, lab)
        js_new, jaux = jg(js, JaxBatch(*map(jnp.asarray, a)), sub,
                          JaxBatch(*map(jnp.asarray, lab)))
        assert set(aux) == {"g_loss", "sup_ctc"}
        check(aux, jaux, new, js_new, "g", pc.gan.g_lr)
        js = js_new
    assert int(js.step) == 3


def test_three_eodm_steps_match_jax(tmp_path):
    examples, vocab = corpus()
    jc, pc = cfgs("bce_eodm", tmp_path, len(vocab))
    jc = dataclasses.replace(jc, train=dataclasses.replace(jc.train, mode="eodm"))
    pc = dataclasses.replace(pc, train=dataclasses.replace(pc.train, mode="eodm"))
    text = [ids for _, ids in examples]
    steps = batches(examples, 3)
    jtr = jax_train.EODMTrainer(jc, text)
    jstate = jtr.init_state(jax.random.PRNGKey(0), JaxBatch(*map(jnp.asarray, steps[0])))
    trainer = train.EODMTrainer(pc, text, device="cpu")
    trainer.gen.load_state_dict(flax_to_state_dict(jax.tree.map(np.asarray, jstate.params), pc))
    state = trainer.init_state()
    step = jtr.jitted_train_step()
    for b in steps:
        jstate, jaux = step(jstate, JaxBatch(*map(jnp.asarray, b)))
        state, aux = trainer.train_step(state, b)
        assert set(aux) == set(jaux)
        for k, v in jaux.items():
            np.testing.assert_allclose(float(aux[k]), float(v), rtol=1e-4, err_msg=k)
    want = flax_to_state_dict(jax.tree.map(np.asarray, jstate.params), pc)
    for k, v in want.items():
        np.testing.assert_allclose(state.params[k].detach().numpy(), v.numpy(), rtol=0,
                                   atol=1e-4, err_msg=k)
