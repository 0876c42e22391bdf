"""Cases shared by tests/test_torch_parallel.py (2-rank gloo groups, the
dry run) and tests/test_torch_parallel_tp.py (4-rank groups): port and
JAX configurations, JAX's reference steps, the spawn of a group of
tests/_torch_dist_worker.py ranks (``uasr_torch.parallel.launch``, one
intra-op thread a rank, a join timeout that kills the group and fails
the test) and the comparisons at the one-process parity tests' bars:
aux values rtol 1e-4 (accuracies atol 1e-6), parameters atol 1e-4 (f32;
summation order only); the attention key projections' biases, whose
gradient is zero but for rounding, at most an Adam step (lr) from JAX's
on each side."""

import dataclasses
import itertools
import pathlib
import pickle
import threading

import numpy as np

import jax
import jax.numpy as jnp

from tests._torch_unsup_cases import B as GAN_B
from tests._torch_unsup_cases import batches as gan_batches
from tests._torch_unsup_cases import cfgs as gan_cfgs
from tests._torch_unsup_cases import corpus as gan_corpus
from uasr import train as jax_train
from uasr.config import Config as JaxConfig
from uasr.config import CTCConfig as JaxCTCConfig
from uasr.config import FrontendConfig as JaxFrontendConfig
from uasr.config import ModelConfig as JaxModelConfig
from uasr.config import SSLConfig as JaxSSLConfig
from uasr.config import TrainConfig as JaxTrainConfig
from uasr.data import dataset as jds
from uasr_torch import config as tc
from uasr_torch.convert import cpc_to_state_dict, critic_to_state_dict, flax_to_state_dict
from uasr_torch.data import dataset as pds
from uasr_torch.data.dataset import text_batch_iterator
from uasr_torch.parallel.launch import launch

REPO = pathlib.Path(__file__).resolve().parents[1]
TIMEOUT = 180
ATOL = 1e-4
RTOL = 1e-4
CTC_MODEL = dict(encoder="conv_bigru", hidden_size=8, num_gru_layers=2, conv_channels=4)
ATTN_MODEL = dict(hidden_size=32, num_heads=4, transformer_layers=2, conv_channels=4,
                  conformer_kernel=7, conformer_rel_clip=8)
SSL = dict(conv_channels=(16, 16, 32), conv_kernels=(8, 4, 4), conv_strides=(4, 2, 1),
           context_hidden=16, predict_steps=3, num_negatives=4, front="patch", patch_size=20)


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def jb(b):
    return type(b)(*map(jnp.asarray, b)) if hasattr(b, "_fields") else jds.Batch(
        *map(jnp.asarray, b))


def sd(state_dict) -> dict:
    return {k: v.numpy() for k, v in state_dict.items()}


def start(cases, world, tmp):
    """Run ``cases`` on a ``world``-rank gloo group in a thread; returns a
    function that joins it and gives each rank's results."""
    spec = tmp / "spec.pkl"
    spec.write_bytes(pickle.dumps(cases))
    err: list = []

    def run():
        try:
            launch(["-m", "tests._torch_dist_worker", str(spec), str(tmp / "out")], world,
                   timeout=TIMEOUT, cwd=str(REPO))
        except BaseException as e:  # noqa: BLE001 - re-raised in the joining thread
            err.append(e)

    th = threading.Thread(target=run)
    th.start()

    def join():
        th.join()
        if err:
            raise err[0]
        return [pickle.loads((tmp / f"out.rank{r}").read_bytes()) for r in range(world)]

    return join


def same_on_every_rank(results, name):
    first = results[0][name]
    for other in results[1:]:
        for key in ("params", "g_params", "d_params"):
            for k, v in first.get(key, {}).items():
                np.testing.assert_array_equal(other[name][key][k], v, err_msg=f"{name} {k}")
    return first


def check_params(ours: dict, want: dict, lr: float = 0.0, what: str = ""):
    assert set(ours) == set(want), what
    for k, v in want.items():
        if k.endswith("key.bias"):  # rounding-floor gradient: an Adam step each side
            assert float(np.abs(ours[k] - v).max()) <= 2 * lr + 1e-7, (what, k)
            continue
        np.testing.assert_allclose(ours[k], v, rtol=0, atol=ATOL, err_msg=f"{what} {k}")


def check_aux(ours: dict, want: dict, what: str = ""):
    for k, v in want.items():
        if k in ("frame_acc", "nce_acc"):
            np.testing.assert_allclose(ours[k], float(v), atol=1e-6, err_msg=f"{what} {k}")
        else:
            np.testing.assert_allclose(ours[k], float(v), rtol=RTOL, atol=1e-7,
                                       err_msg=f"{what} {k}")


def check_gan(res, ref, what):
    """Critic, critic and generator steps: every aux value and both nets."""
    auxes, g_want, d_want = ref
    assert len(res["aux"]) == len(auxes) == 3
    for ours, theirs in zip(res["aux"], auxes):
        check_aux(ours, theirs, what)
    assert {"g_entropy", "g_diversity", "g_smooth"} <= set(res["aux"][2])
    check_params(res["g_params"], g_want, what=f"{what} generator")
    check_params(res["d_params"], d_want, what=f"{what} critic")


# -------------------------------------------------------------- cases


def ctc_batches(n, B=4, seed=0):
    examples, vocab = pds.make_synthetic_dataset(num_utts=B * n, num_phones=6, seed=seed)
    it = pds.batch_iterator(examples, B, 16000, 8, shuffle=False)
    return [tuple(np.asarray(x) for x in b) for b in itertools.islice(it, n)], vocab


def ctc_case(vocab_len, grad_accum=1, model=CTC_MODEL, mode="ctc", m=1, downsample=1):
    """(port config, JAX config) of a CTCTrainer step."""
    train_kw = dict(mode=mode, lr=1e-3, lr_schedule="constant", total_steps=4,
                    grad_accum=grad_accum)
    front = dict(num_mel_bins=16, downsample=downsample)
    pc = tc.Config(frontend=tc.FrontendConfig(**front),
                   model=tc.ModelConfig(gru_pallas=True, attn_pallas=True, **model),
                   ctc=tc.CTCConfig(use_pallas=True), train=tc.TrainConfig(**train_kw),
                   parallel=tc.ParallelConfig(model_parallel=m), vocab_size=vocab_len)
    jc = JaxConfig(frontend=JaxFrontendConfig(**front), model=JaxModelConfig(**model),
                   train=JaxTrainConfig(**train_kw), vocab_size=vocab_len)
    return pc, jc


def jax_ctc(jc, batches, rel_seed=None):
    """JAX's CTCTrainer from its init: (initial params, a function that
    runs its steps over ``batches`` -> (per-call aux, final params))."""
    jtr = jax_train.CTCTrainer(jc)
    jtr.frontend_state  # built eagerly: a lazy build inside jit leaks a tracer
    feats, flen = jax.jit(jtr._feats)(batches[0][0], batches[0][1])
    params = jax.jit(jtr.model.init)(jax.random.PRNGKey(0), feats, flen)
    if rel_seed is not None:  # the conformer's relative-position tables off zero
        rng = np.random.RandomState(rel_seed)
        params = jax.tree_util.tree_map_with_path(
            lambda p, x: jnp.asarray(rng.randn(*x.shape).astype(np.float32) * 0.3)
            if "rel_bias" in jax.tree_util.keystr(p) else x, params)
    init = to_np(params)

    def run():
        state = jax_train.TrainState(jnp.zeros((), jnp.int32), params,
                                     jtr.optimizer.init(params))
        step = jtr.jitted_train_step()
        auxes = []
        for b in batches:
            batch = jds.AlignedBatch(*map(jnp.asarray, b)) if len(b) == 5 else jb(b)
            state, aux = step(state, batch, jax.random.PRNGKey(1))
            auxes.append({k: float(v) for k, v in aux.items()})
        return auxes, to_np(state.params)

    return init, run


def unsup_cases(tmp, m=1):
    """The GAN critic, critic and generator steps (bce, the three output
    penalties, label smoothing, critic weight decay) and an EODM step of
    the classifier from JAX's initial state, on ``model_parallel: m``:
    (GAN spec, EODM spec, a function giving JAX's (GAN ref, EODM ref))."""
    examples, vocab = gan_corpus()
    jc, pc = gan_cfgs("bce_eodm", tmp / "gan", len(vocab))
    pc = dataclasses.replace(pc, parallel=tc.ParallelConfig(model_parallel=m))
    audio = gan_batches(examples, 3)
    text = [ids for _, ids in examples]
    texts = list(itertools.islice(text_batch_iterator(text, GAN_B, 8, seed=0), 2))
    jtr = jax_train.GANTrainer(jc)
    jtr.frontend_state  # built eagerly: a lazy build inside jit leaks a tracer
    js = jax.jit(jtr.init_state)(jax.random.PRNGKey(0), jb(audio[0]),
                                 jds.TextBatch(*map(jnp.asarray, texts[0])))
    init = to_np(js)
    rng, eps, subs = jax.random.PRNGKey(7), [], []
    for _ in range(3):
        rng, sub = jax.random.split(rng)
        subs.append(sub)
        eps.append(np.asarray(jax.random.uniform(sub, (GAN_B, 1, 1), dtype=jnp.float32)))
    gan_spec = dict(kind="gan", cfg=pc, text=text, eodm=False,
                    g_weights=sd(flax_to_state_dict(init.g_params, pc)),
                    d_weights=sd(critic_to_state_dict(init.d_params, pc)),
                    d_audio=audio[:2], d_text=texts, eps=eps[:2], g_audio=audio[2])
    jce = dataclasses.replace(jc, train=dataclasses.replace(jc.train, mode="eodm"))
    pce = dataclasses.replace(pc, train=dataclasses.replace(pc.train, mode="eodm"))
    etr = jax_train.EODMTrainer(jce, text)
    etr.frontend_state
    es = jax.jit(etr.init_state)(jax.random.PRNGKey(0), jb(audio[0]))
    eodm_spec = dict(kind="eodm", cfg=pce, text=text, batch=audio[0],
                     weights=sd(flax_to_state_dict(to_np(es.params), pce)))

    def refs():
        state, auxes = js, []
        jd, jg = jax.jit(jtr.d_step), jax.jit(jtr.g_step)
        for a, t, sub in zip(audio[:2], texts, subs):
            state, aux = jd(state, jb(a), jds.TextBatch(*map(jnp.asarray, t)), sub)
            auxes.append({k: float(v) for k, v in aux.items()})
        state, aux = jg(state, jb(audio[2]), subs[2])
        auxes.append({k: float(v) for k, v in aux.items()})
        state = to_np(state)
        gan_ref = (auxes, sd(flax_to_state_dict(state.g_params, pc)),
                   sd(critic_to_state_dict(state.d_params, pc)))
        new, aux = etr.jitted_train_step()(es, jb(audio[0]))
        eodm_ref = ([{k: float(v) for k, v in aux.items()}],
                    sd(flax_to_state_dict(to_np(new.params), pce)))
        return gan_ref, eodm_ref

    return gan_spec, eodm_spec, refs


def ssl_case(tmp):
    """The dev eval of a ragged batch (B = 5, which the mesh pads to 6) and
    one SSL step (patch front, sampled negatives drawn by JAX for the
    global batch): (spec, a function giving JAX's (step ref, eval ref))."""
    from uasr import pretrain as jpre
    from uasr.config import DataConfig as JaxDataConfig
    from uasr.ops import infonce as jnce

    B = 8
    train_kw = dict(mode="ssl", lr=3e-3, lr_schedule="constant", total_steps=1)
    data = dict(batch_size=B, max_audio_seconds=0.4, max_label_len=8)
    jc = JaxConfig(model_dir=str(tmp / "ssl"), ssl=JaxSSLConfig(**SSL),
                   model=JaxModelConfig(dtype="float32"), data=JaxDataConfig(**data),
                   train=JaxTrainConfig(**train_kw), vocab_size=10)
    pc = tc.Config(model_dir=str(tmp / "ssl"), ssl=tc.SSLConfig(**SSL),
                   model=tc.ModelConfig(dtype="float32"), data=tc.DataConfig(**data),
                   train=tc.TrainConfig(**train_kw), vocab_size=10)
    examples, _ = pds.make_synthetic_dataset(num_utts=B, num_phones=8, seed=5)
    b = tuple(np.asarray(x) for x in next(iter(pds.batch_iterator(examples, B, 6400, 8,
                                                                  seed=0))))
    jt = jpre.SSLTrainer(jc)
    batch = jb(b)
    params = jax.jit(jt.model.init)(jax.random.PRNGKey(0), batch.audio, batch.audio_lengths)
    flen = -(-batch.audio_lengths // 20)  # the patch front, then the strides 4, 2, 1
    for st in (4, 2):
        flen = -(-flen // st)
    rng, dev_rng = jax.random.PRNGKey(100), jax.random.PRNGKey(101)
    dev = jb(tuple(x[:5] for x in b))
    dev_negs = np.asarray(jnce.sample_negatives(dev_rng, flen[:5], 4, 40))
    spec = dict(kind="ssl", cfg=pc, batch=b, weights=sd(cpc_to_state_dict(to_np(params), pc)),
                negatives=np.asarray(jnce.sample_negatives(rng, flen, 4, 40)),
                dev=tuple(x[:5] for x in b),
                dev_negatives=np.concatenate([dev_negs, np.zeros((1, 4), dev_negs.dtype)]))

    def ref():
        loss, acc = jt.jitted_eval_step()(params, dev, dev_rng)
        state = jax_train.TrainState(jnp.zeros((), jnp.int32), params,
                                     jt.optimizer.init(params))
        state, aux = jt.jitted_train_step()(state, batch, rng)
        return ([{k: float(aux[k]) for k in ("nce_loss", "nce_acc", "grad_norm")}],
                sd(cpc_to_state_dict(to_np(state.params), pc)),
                {"nce_loss": float(loss), "nce_acc": float(acc)})

    return spec, ref


def decode_case(tmp):
    """A cnn model's beam-4 decode of two ragged batches of 5 (the mesh
    pads each to 6, JAX's 8-device mesh to 8) against JAX's run_inference:
    (spec, a function giving JAX's result and hypothesis file)."""
    from uasr.infer import run_inference as jax_run_inference

    examples, vocab = pds.make_synthetic_dataset(num_utts=10, num_phones=8, seed=11)
    model = dict(encoder="cnn", hidden_size=64, num_conv_layers=1)
    front = dict(num_mel_bins=40, cmvn="utterance")
    jc = JaxConfig(frontend=JaxFrontendConfig(**front), model=JaxModelConfig(**model),
                   ctc=JaxCTCConfig(blank_id=0, use_beam=True, beam_width=4),
                   vocab_size=len(vocab))
    pc = tc.Config(frontend=tc.FrontendConfig(**front), model=tc.ModelConfig(**model),
                   ctc=tc.CTCConfig(blank_id=0, use_beam=True, beam_width=4),
                   vocab_size=len(vocab))
    batches = [tuple(np.asarray(x) for x in b) for b in pds.batch_iterator(
        examples, 5, 16000, 8, shuffle=False, drop_remainder=False, num_epochs=1)]
    assert [len(b[0]) for b in batches] == [5, 5]
    jtr = jax_train.CTCTrainer(jc)
    jtr.frontend_state
    state = jax.jit(jtr.init_state)(jax.random.PRNGKey(0), jb(batches[0]))
    spec = dict(kind="decode", cfg=pc, batches=batches, vocab=vocab,
                hyp_path=str(tmp / "hyp_port.txt"),
                weights=sd(flax_to_state_dict(to_np(state.params), pc)))

    def ref():
        res = jax_run_inference(jc, jtr, state, [jds.Batch(*b) for b in batches],
                                vocab=jds_vocab(vocab), hyp_path=str(tmp / "hyp_jax.txt"))
        return dict(res=res, hyp=str(tmp / "hyp_jax.txt"))

    return spec, ref


def jds_vocab(vocab):
    """The JAX package's Vocab of the port's tokens."""
    from uasr.vocab import Vocab as JaxVocab

    return JaxVocab(list(vocab.tokens), blank_id=vocab.blank_id, unk_id=vocab.unk_id)


