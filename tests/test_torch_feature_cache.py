"""Feature caches on the CPU, the port against the JAX package: the cache's
files and reader, the host and the device-resident batch iterators (CPU
tensors; the padded final batch included), the wav2vec-U transforms (PCA,
reservoir, clusters, pooling), the Kaldi matrix readers and writer,
``prepare import-features`` / ``export-kaldi`` / ``kmeans
--feature-cache``, ``tools.featurize`` from a port checkpoint of JAX's
(converted) CPC weights against JAX's ``SSLTrainer.encode`` through the same
transforms; then training over [B, T, D] batches: three gan+eodm
alternations with k-means segmentation, three CTC steps of a classifier and
one self-training round, each from JAX's weights; and the port's CLI alone
from a featurize dump (GAN, ``--mode infer``, ``tools.selftrain``).

Bars: files, batches and transforms bit-equal; featurize 1e-5; the GAN
losses rtol 1e-4 (atol 1e-7) per step (the GAN trainer's bars), CTC loss and grad_norm
rtol 1e-4 per step, parameters after three steps atol 1e-4; self-training
stats equal, the student's parameters atol 1e-4."""

import dataclasses
import itertools
import json
import pathlib
import struct

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from uasr import train as jax_train
from uasr.config import Config as JaxConfig
from uasr.config import CTCConfig as JaxCTCConfig
from uasr.config import DataConfig as JaxDataConfig
from uasr.config import EODMConfig as JaxEODMConfig
from uasr.config import GANConfig as JaxGANConfig
from uasr.config import ModelConfig as JaxModelConfig
from uasr.config import SSLConfig as JaxSSLConfig
from uasr.config import TrainConfig as JaxTrainConfig
from uasr.data import cache as jcache
from uasr.data import kaldi as jkaldi
from uasr.data import transforms as jT
from uasr.data.dataset import Batch as JaxBatch
from uasr.data.dataset import TextBatch as JaxTextBatch
from uasr.tools import prepare as jprepare
from uasr_torch import cli, pretrain, selftrain, train
from uasr_torch import config as tc
from uasr_torch.checkpoint import CheckpointManager
from uasr_torch.convert import cpc_to_state_dict, critic_to_state_dict, flax_to_state_dict
from uasr_torch.data import cache, kaldi
from uasr_torch.data import transforms as T
from uasr_torch.data.dataset import text_batch_iterator
from uasr_torch.ops.eodm import device_ngram_tables
from uasr_torch.tools import featurize, prepare
from uasr_torch.tools import selftrain as st_tool

REPO = pathlib.Path(__file__).resolve().parents[1]
B = 8  # JAX's trainers shard each batch over the suite's 8 CPU devices
D = 6  # cached feature width


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


def _examples(n=11, seed=0, dim=D, vocab=7):
    rng = np.random.RandomState(seed)
    return [(f"u{i}", rng.randn(rng.randint(3, 15), dim).astype(np.float32),
             [int(x) for x in rng.randint(1, vocab, rng.randint(0, 5))]) for i in range(n)]


def _same_batch(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        x = x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        np.testing.assert_array_equal(x, np.asarray(y))


def test_cache_files_and_reader_match_jax(tmp_path):
    ex = _examples()
    cache.write_cache(str(tmp_path / "p"), iter(ex), shard_size=4)
    jcache.write_cache(str(tmp_path / "j"), iter(ex), shard_size=4)
    assert (tmp_path / "p/index.json").read_text() == (tmp_path / "j/index.json").read_text()
    for rec in json.loads((tmp_path / "p/index.json").read_text()):
        a, b = np.load(tmp_path / "p" / rec["path"]), np.load(tmp_path / "j" / rec["path"])
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    ours, ref = cache.FeatureCache(str(tmp_path / "j")), jcache.FeatureCache(str(tmp_path / "p"))
    assert len(ours) == len(ref) == len(ex) and ours.dim == D
    for (u, f, ids), (ju, jf, jids) in zip(ours, ref):
        assert u == ju and ids == jids
        np.testing.assert_array_equal(f, jf)


@pytest.mark.parametrize("drop", [True, False], ids=["drop", "keep"])
def test_feature_batches_match_jax(tmp_path, drop):
    """Host batches, and the device-resident corpus's on CPU tensors, from a
    cache and from a list of (feats, ids) pairs, against JAX's for the same
    seed over two epochs; the padded final batch repeats row 0 with zero
    lengths."""
    ex = _examples()
    cache.write_cache(str(tmp_path), iter(ex), shard_size=4)
    ours, ref = cache.FeatureCache(str(tmp_path)), jcache.FeatureCache(str(tmp_path))
    kw = dict(batch_size=4, max_frames=12, max_label_len=3, seed=2, num_epochs=2,
              drop_remainder=drop)
    n = 0
    for b, jb in itertools.zip_longest(cache.feature_batch_iterator(ours, **kw),
                                       jcache.feature_batch_iterator(ref, **kw)):
        _same_batch(b, jb)
        n += 1
    assert n == (4 if drop else 6)
    pairs = [(f, ids) for _, f, ids in ex]
    for src, jsrc in ((ours, ref), (pairs, pairs)):
        got = list(cache.device_feature_batches(src, device="cpu", **kw))
        want = list(jcache.device_feature_batches(jsrc, **kw))
        assert len(got) == len(want) == n
        for b, jb in zip(got, want):
            assert b[0].device.type == "cpu" and b[0].dtype == torch.float32
            _same_batch(b, jb)
    assert cache.LAST_DEVICE_CORPUS["shape"] == (len(ex), 12, D)
    if not drop:
        last = got[-1]
        assert last[0].shape[0] == 4 and int((last[1] == 0).sum()) == 1


def test_transforms_match_jax(tmp_path):
    rng = np.random.RandomState(4)
    blocks = [rng.randn(rng.randint(5, 40), 5).astype(np.float32) for _ in range(6)]
    acc, jacc = T.StreamingPCA(), jT.StreamingPCA()
    res, jres = T.Reservoir(30, seed=3), jT.Reservoir(30, seed=3)
    for blk in blocks:
        acc.update(blk)
        jacc.update(blk)
        res.update(blk)
        jres.update(blk)
    pca, jpca = acc.finalize(3), jacc.finalize(3)
    for k in ("mean", "components", "explained"):
        np.testing.assert_array_equal(getattr(pca, k), getattr(jpca, k))
    np.testing.assert_array_equal(pca(blocks[0]), jpca(blocks[0]))
    np.testing.assert_array_equal(res.sample(), jres.sample())
    cents = rng.randn(4, 3).astype(np.float32)
    f = pca(blocks[1])
    ids = T.assign_clusters(f, cents)
    np.testing.assert_array_equal(ids, jT.assign_clusters(f, cents))
    np.testing.assert_array_equal(T.pool_adjacent(f, ids), jT.pool_adjacent(f, ids))
    pca.save(str(tmp_path / T.PCA_FILE))
    T.save_kmeans(str(tmp_path / T.KMEANS_FILE), cents)
    (p1, k1), (p2, k2) = T.load_transforms(str(tmp_path)), jT.load_transforms(str(tmp_path))
    np.testing.assert_array_equal(p1.components, p2.components)
    np.testing.assert_array_equal(k1, k2)


def _matrix_ark(path, rng):
    """An ark of every matrix kind the readers take: FM, DM, CM, CM2, CM3
    (random payloads: every byte pattern decodes) and a text matrix."""
    recs = []

    def binary(key, tok, payload):
        recs.append(key.encode() + b" \0B" + tok + b" " + payload)

    m = rng.randn(3, 4)
    dims = b"\x04" + struct.pack("<i", 3) + b"\x04" + struct.pack("<i", 4)
    binary("fm", b"FM", dims + m.astype("<f4").tobytes())
    binary("dm", b"DM", dims + m.astype("<f8").tobytes())
    head = struct.pack("<ffii", -1.5, 3.0, 5, 3)
    binary("cm", b"CM", head + rng.randint(0, 65536, 12).astype("<u2").tobytes()
           + rng.randint(0, 256, 15).astype(np.uint8).tobytes())
    binary("cm2", b"CM2", head + rng.randint(0, 65536, 15).astype("<u2").tobytes())
    binary("cm3", b"CM3", head + rng.randint(0, 256, 15).astype(np.uint8).tobytes())
    recs.append(b"txt  [\n 1 2.5 -3\n 4 5 6 ]\n")
    path.write_bytes(b"".join(recs))


def test_kaldi_matrix_readers_and_writer_match_jax(tmp_path):
    rng = np.random.RandomState(5)
    _matrix_ark(tmp_path / "m.ark", rng)
    got = list(kaldi.iter_feats_ark(str(tmp_path / "m.ark")))
    want = list(jkaldi.iter_feats_ark(str(tmp_path / "m.ark")))
    assert [k for k, _ in got] == [k for k, _ in want] == ["fm", "dm", "cm", "cm2", "cm3", "txt"]
    for (_, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    # an scp without offsets: each record found by skipping the others as matrices
    (tmp_path / "m.scp").write_text("".join(f"{k} {tmp_path / 'm.ark'}\n" for k in
                                            ("cm2", "fm", "txt")))
    got = list(kaldi.iter_feats_scp(str(tmp_path / "m.scp")))
    want = list(jkaldi.iter_feats_scp(str(tmp_path / "m.scp")))
    for (k, a), (jk, b) in zip(got, want, strict=True):
        assert k == jk
        np.testing.assert_array_equal(a, b)
    ex = [(u, f) for u, f, _ in _examples(4)]
    kaldi.write_feats_ark(str(tmp_path / "p/feats"), ex)
    jkaldi.write_feats_ark(str(tmp_path / "j/feats"), ex)
    assert (tmp_path / "p/feats.ark").read_bytes() == (tmp_path / "j/feats.ark").read_bytes()
    for k, f in kaldi.iter_feats_scp(str(tmp_path / "p/feats.scp")):
        np.testing.assert_array_equal(f, dict(ex)[k])


def _cache_contents(path):
    return [(u, f.tolist(), ids) for u, f, ids in jcache.FeatureCache(str(path))]


def test_prepare_feature_commands_match_jax(tmp_path):
    """import-features from .npy files, one .npz and a Kaldi scp;
    export-kaldi; kmeans --feature-cache: the port's outputs equal JAX's."""
    ex = _examples(6, vocab=4)
    toks = ["aa", "b", "k"]
    (tmp_path / "vocab.txt").write_text("\n".join(["<blk>", *toks, "<unk>"]) + "\n")
    (tmp_path / "list.tsv").write_text("".join(
        f"{u}\t{u}.wav\t{' '.join(toks[i - 1] for i in ids)}\n" for u, _, ids in ex))
    (tmp_path / "npy").mkdir()
    for u, f, _ in ex:
        np.save(tmp_path / "npy" / f"{u}.npy", f)
    np.savez(tmp_path / "feats.npz", **{u: f for u, f, _ in ex})
    kaldi.write_feats_ark(str(tmp_path / "feats"), [(u, f) for u, f, _ in ex])
    for src in ("npy", "feats.npz", "feats.scp"):
        args = ["import-features", "--features", str(tmp_path / src), "--list",
                str(tmp_path / "list.tsv"), "--vocab", str(tmp_path / "vocab.txt"),
                "--shard-size", "4", "--out"]
        prepare.main(args + [str(tmp_path / f"p_{src}")])
        jprepare.main(args + [str(tmp_path / f"j_{src}")])
        assert _cache_contents(tmp_path / f"p_{src}") == _cache_contents(tmp_path / f"j_{src}")
    assert [ids for _, _, ids in _cache_contents(tmp_path / "p_npy")] == [i for _, _, i in ex]
    for mod, tag in ((prepare, "p"), (jprepare, "j")):
        mod.main(["export-kaldi", "--feature-cache", str(tmp_path / "p_npy"), "--out",
                  str(tmp_path / tag / "out")])
    assert (tmp_path / "p/out.ark").read_bytes() == (tmp_path / "j/out.ark").read_bytes()
    recipe = str(REPO / "configs" / "wav2vecu_pod_stretch.yaml")
    for mod, tag in ((prepare, "p"), (jprepare, "j")):
        mod.main(["kmeans", "--config", recipe, "--feature-cache", str(tmp_path / "p_npy"),
                  "--clusters", "3", "--iters", "4", "--out", str(tmp_path / f"km_{tag}.npz")])
    np.testing.assert_array_equal(np.load(tmp_path / "km_p.npz")["centroids"],
                                  np.load(tmp_path / "km_j.npz")["centroids"])


# ---------------------------------------------------------------- featurize

SSL = dict(front="patch", patch_size=20, conv_channels=(16, 16, 32), conv_kernels=(8, 4, 4),
           conv_strides=(4, 2, 1), context_hidden=16, predict_steps=3, num_negatives=4)


@pytest.fixture(scope="module")
def ssl_ckpt(tmp_path_factory):
    """A port SSL checkpoint holding JAX's (jitted, converted) CPC init, its
    config, and JAX's parameters; the synthetic corpus of 20 utterances."""
    from uasr import pretrain as jpre

    root = tmp_path_factory.mktemp("ssl")
    data = dict(synthetic=True, synthetic_num_utts=20, synthetic_dev_utts=10, batch_size=B,
                max_audio_seconds=0.5, max_label_len=8)
    train_kw = dict(mode="ssl", total_steps=1)
    pc = tc.Config(model_dir=str(root), ssl=tc.SSLConfig(**SSL),
                   model=tc.ModelConfig(dtype="float32"), data=tc.DataConfig(**data),
                   train=tc.TrainConfig(**train_kw), vocab_size=10)
    jc = JaxConfig(model_dir=str(root), ssl=JaxSSLConfig(**SSL),
                   model=JaxModelConfig(dtype="float32"), data=JaxDataConfig(**data),
                   train=JaxTrainConfig(**train_kw), vocab_size=10)
    jt = jpre.SSLTrainer(jc)
    audio = jnp.zeros((B, 8000), jnp.float32)
    params = jax.jit(jt.model.init)(jax.random.PRNGKey(3), audio, jnp.full((B,), 8000))
    pt = pretrain.SSLTrainer(pc, device="cpu")
    pt.model.load_state_dict(cpc_to_state_dict(jax.tree.map(_np, params), pc))
    CheckpointManager(f"{root}/ckpt").save(1, pt.init_state())
    encode = jax.jit(lambda p, a, n: jt.encode(p, a, n))
    return dict(pc=pc, jt=jt, params=params, encode=encode, root=root)


def _jax_features(ssl, split, layer="context"):
    """JAX's encode of the split's batches (the port's numpy batches), one
    [T, D] array and label list per utterance."""
    pc = ssl["pc"]
    source, _ = cli._load_source(pc, split)
    out = []
    for b in cli._batches(pc, source, num_epochs=1, drop_remainder=False):
        z, c, _, flen = ssl["encode"](ssl["params"], jnp.asarray(b[0]), jnp.asarray(b[1]))
        f = _np(c if layer == "context" else z)
        for j in range(f.shape[0]):
            out.append((f[j, : int(flen[j])], list(b[2][j][: int(b[3][j])])))
    return out


def test_featurize_matches_jax_encode(ssl_ckpt, tmp_path):
    """The plain dump (context), the latents, and --cmvn --pca 8
    --pool-kmeans 4 with the dev split through the train split's
    transforms: the port's cache against JAX's encode through the same
    (port-fitted) transforms, within 1e-5; the fitted PCA bit-equal to JAX's
    StreamingPCA over the port's frames."""
    pc = ssl_ckpt["pc"]
    dump = featurize.dump_features
    src = cli._load_source(pc, "train")[0]
    assert dump(pc, src, str(tmp_path / "ctx"), device="cpu") == 20
    assert dump(pc, src, str(tmp_path / "lat"), layer="latents", device="cpu") == 20
    assert dump(pc, src, str(tmp_path / "w2v"), cmvn=True, pca_dim=8, pool_clusters=4,
                sample_frames=200, device="cpu") == 20
    dev_src = cli._load_source(pc, "dev")[0]
    assert dump(pc, dev_src, str(tmp_path / "w2v_dev"), cmvn=True, pca_dim=8, pool_clusters=4,
                transforms_from=str(tmp_path / "w2v"), device="cpu") == 10
    pca, km = jT.load_transforms(str(tmp_path / "w2v"))
    assert pca.components.shape == (8, 16) and km.shape == (4, 8)
    for name, split, layer, prep in (("ctx", "train", "context", False),
                                     ("lat", "train", "latents", False),
                                     ("w2v", "train", "context", True),
                                     ("w2v_dev", "dev", "context", True)):
        want = _jax_features(ssl_ckpt, split, layer)
        got = list(cache.FeatureCache(str(tmp_path / name)))
        assert len(got) == len(want)
        cmvn_frames = []
        for (_, f, ids), (jf, jids) in zip(got, want):
            assert ids == jids
            if prep:
                jf = (jf - jf.mean(0, keepdims=True)) / (jf.std(0, keepdims=True) + 1e-5)
                cmvn_frames.append(jf)
                jf = pca(jf)
                jf = jT.pool_adjacent(jf, jT.assign_clusters(jf, km))
            assert f.shape == jf.shape, name
            np.testing.assert_allclose(f, jf, rtol=0, atol=1e-5, err_msg=name)
        if name == "w2v":
            acc = jT.StreamingPCA()
            for fr in cmvn_frames:
                acc.update(fr)
            np.testing.assert_allclose(acc.finalize(8).mean, pca.mean, atol=1e-5)


# ------------------------------------------------- training over features

GAN_MODEL = dict(encoder="classifier", classifier_hidden=16, classifier_layers=2,
                 classifier_context=1, disc_channels=8, disc_layers=2, disc_kernel=5)
GAN = dict(objective="bce", disc_steps=1, g_lr=3e-3, d_lr=5e-3, merge_repeats=True,
           segmenter="kmeans", kmeans_clusters=3, max_segments=12, entropy_weight=0.2)
EODM = dict(ngram_orders=(1, 2), top_k=20, k_chunk=8)
TRAIN = dict(lr=2e-3, lr_schedule="constant", total_steps=3, log_every=1, eval_every=1000,
             save_every=1000, seed=0)


@pytest.fixture(scope="module")
def feat_run(tmp_path_factory):
    """A feature cache of 24 utterances (D = 6, V = 7), its centroids, the
    configs of both packages over it, and JAX's initial generator and critic
    (the GAN's) with JAX's gan+eodm run over three alternations."""
    root = tmp_path_factory.mktemp("feats")
    ex = _examples(24, seed=7)
    cache.write_cache(str(root / "cache"), iter(ex), shard_size=8)
    np.savez(root / "km.npz", centroids=np.random.RandomState(8).randn(3, D).astype(np.float32))
    data = dict(feature_cache=str(root / "cache"), batch_size=B, max_frames=14, max_label_len=4)
    kw = dict(model=GAN_MODEL, gan=dict(GAN, centroids_path=str(root / "km.npz")), eodm=EODM,
              data=data, train=dict(TRAIN, mode="gan+eodm"))
    jc = JaxConfig(model_dir=str(root / "jax"), model=JaxModelConfig(**kw["model"]),
                   ctc=JaxCTCConfig(), gan=JaxGANConfig(**kw["gan"]),
                   eodm=JaxEODMConfig(**kw["eodm"]), data=JaxDataConfig(**kw["data"]),
                   train=JaxTrainConfig(**kw["train"]), vocab_size=7)
    pc = tc.Config(model_dir=str(root / "port"), model=tc.ModelConfig(**kw["model"]),
                   ctc=tc.CTCConfig(), gan=tc.GANConfig(**kw["gan"]),
                   eodm=tc.EODMConfig(**kw["eodm"]), data=tc.DataConfig(**kw["data"]),
                   train=tc.TrainConfig(**kw["train"]), vocab_size=7)
    it = cache.feature_batch_iterator(cache.FeatureCache(str(root / "cache")), B, 14, 4, seed=0)
    batches = [tuple(_np(x) for x in b) for b in itertools.islice(it, 6)]
    text = [ids for _, _, ids in ex if ids]
    init = jax_train.GANTrainer(jc).init_state(
        jax.random.PRNGKey(0), JaxBatch(*map(jnp.asarray, batches[0])),
        JaxTextBatch(*map(jnp.asarray, next(text_batch_iterator(text, B, 4, seed=0)))))
    _, final = jax_train.run_gan_training(jc, iter(batches), text, with_eodm=True)
    recs = [json.loads(ln) for ln in (root / "jax/metrics.jsonl").read_text().splitlines()]
    return dict(root=root, ex=ex, jc=jc, pc=pc, batches=batches, text=text,
                init=jax.tree.map(_np, init), final=jax.tree.map(_np, final), recs=recs)


def _jax_eps(seed, steps, disc_steps):
    rng, out = jax.random.PRNGKey(seed), []
    for _ in range(steps):
        for _ in range(disc_steps):
            rng, sub = jax.random.split(rng)
            out.append(np.asarray(jax.random.uniform(sub, (B, 1, 1), dtype=jnp.float32)))
        rng, _ = jax.random.split(rng)
    return out


def test_three_gan_alternations_over_features_match_jax(feat_run):
    pc = feat_run["pc"]
    trainer = train.GANTrainer(pc, device="cpu",
                               tables=device_ngram_tables(pc.eodm, feat_run["text"], "cpu"))
    trainer.gen.load_state_dict(flax_to_state_dict(feat_run["init"].g_params, pc))
    trainer.disc.load_state_dict(critic_to_state_dict(feat_run["init"].d_params, pc))
    state = trainer.init_state()
    audio = iter(feat_run["batches"])
    text_it = text_batch_iterator(feat_run["text"], B, 4, seed=pc.train.seed)
    eps = iter(_jax_eps(pc.train.seed, 3, 1))
    for rec in feat_run["recs"]:
        state, d_aux = trainer.d_step(state, next(audio), next(text_it),
                                      eps=torch.tensor(next(eps)))
        state, g_aux = trainer.g_step(state, next(audio))
        assert rec["step"] == state.step
        for name, v in {**d_aux, **g_aux}.items():
            np.testing.assert_allclose(float(v), rec[name], rtol=1e-4, atol=1e-7,
                                       err_msg=f"{name} @ step {state.step}")
    assert state.step == 3
    for ours, ref in ((state.g_params, flax_to_state_dict(feat_run["final"].g_params, pc)),
                      (state.d_params, critic_to_state_dict(feat_run["final"].d_params, pc))):
        for k, v in ref.items():
            np.testing.assert_allclose(ours[k].detach().numpy(), v.numpy(), rtol=0, atol=1e-4,
                                       err_msg=k)


def _ctc_cfgs(feat_run, mode="ctc"):
    jc, pc = feat_run["jc"], feat_run["pc"]
    jtr = dataclasses.replace(jc.train, mode=mode)
    ptr = dataclasses.replace(pc.train, mode=mode)
    return jc.replace(train=jtr), pc.replace(train=ptr)


def test_three_ctc_steps_over_features_match_jax(feat_run):
    """A classifier trained with CTC on [B, T, D] batches (the frontend
    bypassed; the model's width is the cache's D)."""
    jc, pc = _ctc_cfgs(feat_run)
    jt = jax_train.CTCTrainer(jc)
    b0 = JaxBatch(*map(jnp.asarray, feat_run["batches"][0]))
    params = jax.jit(jt.model.init)(jax.random.PRNGKey(1), b0.audio, b0.audio_lengths)
    jstate = jax_train.TrainState(jnp.zeros((), jnp.int32), params, jt.optimizer.init(params))
    pt = train.CTCTrainer(pc, device="cpu")
    assert pt.model.context_conv.weight.shape[1] == D  # the cache's width
    pt.model.load_state_dict(flax_to_state_dict(jax.tree.map(_np, params), pc))
    state = pt.init_state()
    step = jt.jitted_train_step()
    for i, b in enumerate(feat_run["batches"][:3]):
        jstate, jaux = step(jstate, JaxBatch(*map(jnp.asarray, b)), jax.random.PRNGKey(i))
        state, aux = pt.train_step(state, b)
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=1e-4, err_msg=k)
    for k, v in flax_to_state_dict(jax.tree.map(_np, jstate.params), pc).items():
        np.testing.assert_allclose(state.params[k].detach().numpy(), v.numpy(), rtol=0,
                                   atol=1e-4, err_msg=k)


def test_self_train_round_over_features_matches_jax(feat_run, tmp_path):
    """The GAN's initial generator labels the cached features; one CTC
    round of three steps from its weights over the [T, D] examples."""
    from uasr import selftrain as jst

    jc, pc = _ctc_cfgs(feat_run)
    g_params = feat_run["init"].g_params
    jgen = jax_train.GeneratorInfer(jc)
    pgen = train.GeneratorInfer(pc, device="cpu")
    pgen.gen.load_state_dict(flax_to_state_dict(g_params, pc))
    examples = [(f, ids) for _, f, ids in feat_run["ex"]]
    jfn = jst.make_gan_label_fn(jgen, jax.tree.map(jnp.asarray, g_params))
    _, jstate, jh = jst.self_train(jc.replace(model_dir=str(tmp_path / "jax")), jfn, examples,
                                   steps_per_round=3, init_params=g_params, log=lambda *_: None)
    pfn = selftrain.make_gan_label_fn(pgen)
    init = {k: v.clone() for k, v in pgen.gen.state_dict().items()}
    trainer, state, ph = selftrain.self_train(pc.replace(model_dir=str(tmp_path / "port")), pfn,
                                              examples, steps_per_round=3, init_params=init,
                                              log=lambda *_: None, device="cpu")
    assert ph[0]["labeled"] == jh[0]["labeled"] and ph[0]["total"] == jh[0]["total"] == 24
    np.testing.assert_allclose(ph[0]["mean_conf"], jh[0]["mean_conf"], rtol=1e-5)
    assert state.step == 3
    for k, v in flax_to_state_dict(jax.tree.map(_np, jstate.params), pc).items():
        np.testing.assert_allclose(state.params[k].detach().numpy(), v.numpy(), rtol=0,
                                   atol=1e-4, err_msg=k)


def test_cli_gan_infer_and_selftrain_from_a_featurize_dump(ssl_ckpt, tmp_path, capsys):
    """The port alone: featurize the SSL checkpoint's corpus, fit the
    segmenter on the cache, then wav2vecu_pod_stretch (narrowed) trains,
    decodes and self-trains from it through the CLI and the tools."""
    pc = ssl_ckpt["pc"]
    feats = str(tmp_path / "feats")
    featurize.main(["-c", str(REPO / "configs" / "ssl_pretrain_demo.yaml"), "--device", "cpu",
                    "--out", feats, "--cmvn", "--pca", "8", "--pool-kmeans", "4",
                    "--sample-frames", "200", *sum((["--set", f"ssl.{k}={v}"] for k, v in (
                        ("front", "patch"), ("patch_size", 20),
                        ("conv_channels", "16,16,32"), ("conv_kernels", "8,4,4"),
                        ("conv_strides", "4,2,1"), ("context_hidden", 16),
                        ("predict_steps", 3), ("num_negatives", 4))), []),
                    "--set", f"model_dir={pc.model_dir}", "--set", "data.synthetic_num_utts=20",
                    "--set", "data.max_audio_seconds=0.5"])
    (tmp_path / "vocab.txt").write_text("\n".join(f"p{i}" for i in range(8)) + "\n<unk>\n")
    recipe = str(REPO / "configs" / "wav2vecu_pod_stretch.yaml")
    prepare.main(["kmeans", "--config", recipe, "--feature-cache", feats, "--clusters", "3",
                  "--iters", "3", "--out", str(tmp_path / "km.npz")])
    sets = sum((["--set", s] for s in (
        "parallel.model_parallel=1", f"data.feature_cache={feats}",
        f"data.dev_feature_cache={feats}", f"data.test_feature_cache={feats}",
        f"gan.centroids_path={tmp_path / 'km.npz'}", f"data.vocab_path={tmp_path / 'vocab.txt'}",
        "data.text_path=none", "data.batch_size=8", "model.classifier_hidden=16",
        "model.disc_channels=8", "model.dtype=float32", "eodm.top_k=16", "train.log_every=1",
        "train.eval_every=2", f"model_dir={tmp_path / 'gan'}")), [])
    args = ["-c", recipe, "--device", "cpu", *sets]
    assert cli.main(args + ["--set", "train.total_steps=2"]) == 0
    recs = [json.loads(ln) for ln in (tmp_path / "gan/metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs] == [1, 2, 2] and "per" in recs[-1]
    assert cli.main(args + ["--mode", "infer"]) == 0
    assert capsys.readouterr().out.splitlines()[-1].startswith("step 2: PER=")
    assert len((tmp_path / "gan/hyp.txt").read_text().splitlines()) == 20
    assert st_tool.main(["-c", recipe, "--device", "cpu", *sets, "--set",
                         f"model_dir={tmp_path / 'st'}", "--teacher-dir", str(tmp_path / "gan"),
                         "--student-steps", "2"]) == 0
    out = capsys.readouterr().out
    assert "teacher PER=" in out and "nan" not in out.splitlines()[-1]
    assert (tmp_path / "st/selftrain_r0/ckpt/2.pt").exists()
