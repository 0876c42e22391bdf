"""SSL pretraining on the CPU, the port against the JAX package on the same
numpy inputs and converted weights (JAX's inits jitted): ``CPCModel``'s
z, c and predictions for each front (strided conv over samples, patch
embed, log-mel frames) and with ``remat_encoder`` and ``fused_loss``;
padding invariance; ``info_nce_loss`` exact and sampled and
``info_nce_loss_fused``, values and gradients, fed JAX's
``sample_negatives`` indices; three ``SSLTrainer`` steps, unfused and
fused, from JAX's initial state with JAX's negatives; then the port's CLI
alone (``train.mode: ssl`` trains, resumes and refuses a feature cache and
``--mode infer``).

Small widths: conv 16/16/32, context 16, K = 3, N = 4. Bars: z / c / preds
f32 1e-5; loss rtol 1e-5 and accuracy equal, gradients atol 2e-4 / rtol
1e-3; training: loss and grad_norm rtol 1e-4 per step, parameters after
three steps atol 1e-4."""

import json
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from uasr.config import Config as JaxConfig
from uasr.config import DataConfig as JaxDataConfig
from uasr.config import ModelConfig as JaxModelConfig
from uasr.config import SSLConfig as JaxSSLConfig
from uasr.config import TrainConfig as JaxTrainConfig
from uasr.data.dataset import Batch as JaxBatch
from uasr.models.ssl import CPCModel as JaxCPC
from uasr.ops import infonce as jnce
from uasr_torch import cli, pretrain
from uasr_torch import config as tc
from uasr_torch.convert import cpc_to_state_dict
from uasr_torch.models.ssl import CPCModel
from uasr_torch.ops import infonce

REPO = pathlib.Path(__file__).resolve().parents[1]
SSL = dict(conv_channels=(16, 16, 32), conv_kernels=(8, 4, 4), conv_strides=(4, 2, 1),
           fbank_conv_channels=(16, 32), fbank_conv_kernels=(3, 3), fbank_conv_strides=(1, 2),
           context_hidden=16, predict_steps=3, num_negatives=4, patch_size=5)
FEAT_DIM = 8
B = 8  # JAX's SSLTrainer builds the suite's 8-device mesh


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite runs files in parallel workers, and an
    oversubscribed pool slows the many small ops here several times."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _np(x):
    return np.asarray(x)


def _inputs(input_type, rng):
    if input_type == "fbank":
        return rng.randn(2, 30, FEAT_DIM).astype(np.float32), np.array([30, 17], np.int32)
    return rng.randn(2, 803).astype(np.float32), np.array([803, 411], np.int32)


@pytest.mark.parametrize("front,input_type,extra", [
    ("conv", "waveform", {}), ("patch", "waveform", {}), ("conv", "fbank", {}),
    ("patch", "waveform", dict(remat_encoder=True)), ("patch", "waveform", dict(fused_loss=True)),
], ids=["conv", "patch", "fbank", "remat", "fused"])
def test_cpc_model_matches_jax(front, input_type, extra):
    kw = dict(SSL, front=front, input_type=input_type, **extra)
    x, n = _inputs(input_type, np.random.RandomState(0))
    jm = JaxCPC(JaxSSLConfig(**kw))
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(n))
    ref = jax.jit(jm.apply)(params, jnp.asarray(x), jnp.asarray(n))
    cfg = tc.SSLConfig(**kw)
    model = CPCModel(cfg, feat_dim=FEAT_DIM)
    model.load_state_dict(cpc_to_state_dict(jax.tree.map(_np, params), cfg))
    model.train()  # remat recomputes only under autograd: exercise that path
    got = model(torch.tensor(x), torch.tensor(n))
    for name, g, r in zip(("z", "c", "preds"), got[:3], ref[:3]):
        assert g.shape == r.shape, name
        np.testing.assert_allclose(g.detach().numpy(), _np(r), rtol=0, atol=1e-5, err_msg=name)
    np.testing.assert_array_equal(got[3].numpy(), _np(ref[3]))


def test_cpc_model_padding_invariance():
    cfg = tc.SSLConfig(**SSL)
    model = CPCModel(cfg)
    model.reset_parameters(torch.Generator().manual_seed(0))
    rng = np.random.RandomState(1)
    L = 4000
    audio = torch.tensor(rng.randn(2, L).astype(np.float32))
    lengths = torch.tensor([L, L // 2])
    with torch.no_grad():
        z1, c1, _, f1 = model(audio, lengths)
        z2, c2, _, f2 = model(torch.cat([audio, torch.zeros(2, 960)], 1), lengths)
    assert torch.equal(f1, f2)
    n = int(f1[1])
    torch.testing.assert_close(z1[1, :n], z2[1, :n], atol=2e-5, rtol=0)
    torch.testing.assert_close(c1[1, :n], c2[1, :n], atol=2e-5, rtol=0)


def test_sample_negatives_in_range():
    lengths = torch.tensor([50, 3, 1, 0])
    neg = infonce.sample_negatives(torch.Generator().manual_seed(0), lengths, 64)
    assert neg.shape == (4, 64) and neg.dtype == torch.long
    for b, L in enumerate([50, 3, 1, 1]):
        assert int(neg[b].min()) >= 0 and int(neg[b].max()) < L


@pytest.mark.parametrize("kind", ["exact", "sampled", "fused"])
def test_info_nce_matches_jax(kind):
    rng = np.random.RandomState(3)
    Bn, T, K, C, Ch = 3, 9, 2, 5, 6
    z = rng.randn(Bn, T, C).astype(np.float32)
    lengths = np.array([9, 6, 3], np.int32)
    neg = None if kind == "exact" else _np(jnce.sample_negatives(
        jax.random.PRNGKey(1), jnp.asarray(lengths), 7, T))
    if kind == "fused":
        c = rng.randn(Bn, T, Ch).astype(np.float32)
        w = rng.randn(Ch, K * C).astype(np.float32)
        b = rng.randn(K * C).astype(np.float32)

        def jfn(c, w, b, z):
            return jnce.info_nce_loss_fused(c, w, b, z, jnp.asarray(lengths), K, 0.2,
                                            jnp.asarray(neg), chunk=4)

        jargs, targs = (c, w, b, z), (c, w.T.copy(), b, z)

        def tfn(c, w, b, z):
            return infonce.info_nce_loss_fused(c, w, b, z, torch.tensor(lengths), K, 0.2,
                                               torch.tensor(neg).long(), chunk=4)
    else:
        preds = rng.randn(Bn, T, K, C).astype(np.float32)
        jneg = None if neg is None else jnp.asarray(neg)
        tneg = None if neg is None else torch.tensor(neg).long()

        def jfn(p, z):
            return jnce.info_nce_loss(p, z, jnp.asarray(lengths), 0.2, jneg)

        def tfn(p, z):
            return infonce.info_nce_loss(p, z, torch.tensor(lengths), 0.2, tneg)

        jargs = targs = (preds, z)
    jx = tuple(map(jnp.asarray, jargs))
    jl, ja = jax.jit(jfn)(*jx)
    jg = jax.jit(jax.grad(lambda *a: jfn(*a)[0], argnums=tuple(range(len(jx)))))(*jx)
    tx = [torch.tensor(a, requires_grad=True) for a in targs]
    tl, ta = tfn(*tx)
    tg = torch.autograd.grad(tl, tx)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    assert float(ta) == float(ja)
    for i, (g, r) in enumerate(zip(tg, jg)):
        r = _np(r).T if (kind == "fused" and i == 1) else _np(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-3, atol=2e-4, err_msg=f"grad {i}")


def _cfgs(model_dir, **ssl):
    kw = dict(SSL, front="patch", patch_size=20, **ssl)
    train_kw = dict(mode="ssl", lr=3e-3, lr_schedule="constant", total_steps=3, log_every=1,
                    eval_every=1000, save_every=1000)
    data = dict(batch_size=B, max_audio_seconds=0.4, max_label_len=8)
    jc = JaxConfig(model_dir=str(model_dir), ssl=JaxSSLConfig(**kw),
                   model=JaxModelConfig(dtype="float32"), data=JaxDataConfig(**data),
                   train=JaxTrainConfig(**train_kw), vocab_size=10)
    pc = tc.Config(model_dir=str(model_dir), ssl=tc.SSLConfig(**kw),
                   model=tc.ModelConfig(dtype="float32"), data=tc.DataConfig(**data),
                   train=tc.TrainConfig(**train_kw), vocab_size=10)
    return jc, pc


@pytest.fixture(scope="module")
def ssl_batches():
    from uasr_torch.data.dataset import batch_iterator, make_synthetic_dataset

    examples, _ = make_synthetic_dataset(num_utts=24, num_phones=8, seed=5)
    it = batch_iterator(examples, B, 6400, 8, seed=0)
    return [tuple(_np(x) for x in next(it)) for _ in range(3)]


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_three_ssl_steps_match_jax(fused, ssl_batches, tmp_path, monkeypatch):
    from uasr import pretrain as jpre
    from uasr.train import TrainState as JaxTrainState

    jc, pc = _cfgs(tmp_path, fused_loss=fused)
    jt = jpre.SSLTrainer(jc)
    first = JaxBatch(*map(jnp.asarray, ssl_batches[0]))
    params = jax.jit(jt.model.init)(jax.random.PRNGKey(0), first.audio, first.audio_lengths)
    jstate = JaxTrainState(jnp.zeros((), jnp.int32), params, jt.optimizer.init(params))
    pt = pretrain.SSLTrainer(pc, device="cpu")
    pt.model.load_state_dict(cpc_to_state_dict(jax.tree.map(_np, params), pc))
    state = pt.init_state()
    negs = []
    monkeypatch.setattr(pretrain, "sample_negatives", lambda g, flen, num: negs.pop(0))
    step = jt.jitted_train_step()
    for i, b in enumerate(ssl_batches):
        jb = JaxBatch(*map(jnp.asarray, b))
        flen = -(-jb.audio_lengths // 20)  # the patch front, then the strides 4, 2, 1
        for st in (4, 2):
            flen = -(-flen // st)
        rng = jax.random.PRNGKey(100 + i)
        negs.append(torch.tensor(_np(jnce.sample_negatives(rng, flen, 4, 40))).long())
        jstate, jaux = step(jstate, jb, rng)
        state, aux = pt.train_step(state, b)
        for k in ("nce_loss", "grad_norm"):
            np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=1e-4,
                                       err_msg=f"{k} @ {i}")
        np.testing.assert_allclose(float(aux["nce_acc"]), float(jaux["nce_acc"]), atol=1e-6)
    assert state.step == 3 and not negs
    want = cpc_to_state_dict(jax.tree.map(_np, jstate.params), pc)
    assert set(want) == set(state.params)
    for k, v in want.items():
        np.testing.assert_allclose(state.params[k].detach().numpy(), v.numpy(), rtol=0,
                                   atol=1e-4, err_msg=k)


DEMO = ["-c", str(REPO / "configs" / "ssl_pretrain_demo.yaml"), "--device", "cpu",
        "--set", "ssl.conv_channels=16,16,32", "--set", "ssl.context_hidden=16",
        "--set", "data.synthetic_num_utts=16", "--set", "data.max_audio_seconds=0.8",
        "--set", "train.log_every=1", "--set", "train.save_every=2"]


def test_ssl_cli_trains_resumes_and_refuses(tmp_path, capsys):
    """``train.mode: ssl`` through the CLI (the exact-softmax demo recipe,
    narrowed): trains and logs, resumes, trains on log-mel frames; refuses
    ``--mode infer`` and a split with a feature cache, as ``uasr.cli`` does."""
    from uasr_torch.data.cache import write_cache

    args = [*DEMO, "--set", f"model_dir={tmp_path / 'wav'}"]
    assert cli.main(args + ["--set", "train.total_steps=2"]) == 0
    recs = [json.loads(ln) for ln in (tmp_path / "wav/metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs] == [1, 2]
    for r in recs:
        assert set(r) >= {"nce_loss", "nce_acc", "grad_norm", "audio_sec_per_sec"}
        assert np.isfinite(r["nce_loss"]) and 0.0 <= r["nce_acc"] <= 1.0
    assert cli.main(args + ["--set", "train.total_steps=3"]) == 0
    out = capsys.readouterr().out
    assert "[resume] step 2: restored_step=2" in out and "[train] step 3:" in out
    assert cli.main([*DEMO, "--set", f"model_dir={tmp_path / 'fb'}", "--set",
                     "train.total_steps=1", "--set", "ssl.input_type=fbank", "--set",
                     "ssl.fbank_conv_channels=16,32", "--set", "frontend.num_mel_bins=16"]) == 0
    assert (tmp_path / "fb/ckpt/1.pt").exists()
    with pytest.raises(SystemExit, match="no decode path"):
        cli.main(args + ["--mode", "infer"])
    write_cache(str(tmp_path / "cache"), [("u0", np.zeros((4, 3), np.float32), [1])])
    (tmp_path / "vocab.txt").write_text("a\nb\n")
    with pytest.raises(SystemExit, match="RAW AUDIO"):
        cli.main(args + ["--set", f"data.feature_cache={tmp_path / 'cache'}",
                         "--set", f"data.vocab_path={tmp_path / 'vocab.txt'}"])
