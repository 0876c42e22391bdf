"""Frame-CE training on the CPU, the port against the JAX package: the loss
and accuracy, the synthetic corpora's alignment tracks and aligned
batches, the Kaldi alignment tables, ``prepare import-ali``, three
frame-CE ``CTCTrainer`` steps from the same converted weights (a
``classifier`` at frontend downsample 3 and a strided ``conv_bigru``,
labels taken every 3 and every 4 frames), and the port's CLI training,
decoding and aligning with a frame-CE checkpoint.

Bars: loss and accuracy 1e-6 relative; tracks, audio, batches, tables and
files bit- or byte-equal; per training step loss, frame_acc and grad norm
rtol 1e-4, parameters after three steps atol 1e-4 (f32, summation order
only)."""

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
from uasr.data import dataset as jds
from uasr.data import kaldi as jkaldi
from uasr.ops import frame_ce as jfce
from uasr.tools import prepare as jax_prepare
from uasr_torch import cli, train
from uasr_torch import config as tc
from uasr_torch.convert import flax_to_state_dict
from uasr_torch.data import dataset as pds
from uasr_torch.data import kaldi
from uasr_torch.data.io import read_utterance_list
from uasr_torch.ops.frame_ce import frame_accuracy, frame_ce_loss
from uasr_torch.tools import align, prepare
from uasr_torch.vocab import load_vocab

REPO_CONFIGS = __import__("pathlib").Path(__file__).resolve().parents[1] / "configs"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite runs files in parallel workers, and
    an oversubscribed pool slows the many small ops here several times."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def test_loss_and_accuracy_match_jax():
    rng = np.random.RandomState(0)
    logits = (2 * rng.randn(3, 9, 6)).astype(np.float32)
    lengths = np.array([9, 5, 0], np.int32)
    labels = rng.randint(0, 6, (3, 11)).astype(np.int32)
    labels[0, 2] = labels[1, 7:] = -1
    labels[0, 4] = np.argmax(logits[0, 4])  # at least one hit
    for ours, ref in ((frame_ce_loss, jfce.frame_ce_loss), (frame_accuracy, jfce.frame_accuracy)):
        got = float(ours(torch.tensor(logits), torch.tensor(lengths), torch.tensor(labels)))
        want = float(jax.jit(ref)(logits, lengths, labels))
        assert want > 0
        np.testing.assert_allclose(got, want, rtol=1e-6)
    # no labelled frame: the divisor is floored at 1
    none = np.full_like(labels, -1)
    assert float(frame_ce_loss(torch.tensor(logits), torch.tensor(lengths),
                               torch.tensor(none))) == 0.0


@pytest.mark.parametrize("style", ["tone", "formant"])
def test_alignment_tracks_and_aligned_batches_match_jax(style):
    ids = [3, 1, 4, 1, 5]
    synth = {"tone": (pds.synth_tone_audio, jds.synth_tone_audio, ()),
             "formant": (pds.synth_formant_audio, jds.synth_formant_audio, (6,))}[style]
    a, t = synth[0](ids, *synth[2], rng=np.random.RandomState(3), return_align=True)
    b, u = synth[1](ids, *synth[2], rng=np.random.RandomState(3), return_align=True)
    assert np.array_equal(a, b) and t == u and len(t) == 1 + (len(a) - 400) // 160
    assert np.array_equal(a, synth[0](ids, *synth[2], rng=np.random.RandomState(3)))

    kw = dict(num_utts=13, num_phones=6, seed=5, with_alignments=True, style=style,
              syntax="markov" if style == "formant" else "iid")
    ours, ov = pds.make_synthetic_dataset(**kw)
    ref, rv = jds.make_synthetic_dataset(**kw)
    assert ov.tokens == rv.tokens and len(ours) == len(ref) == 13
    for (x, i, al), (y, j, bl) in zip(ours, ref):
        assert np.array_equal(x, y) and list(i) == list(j) and list(al) == list(bl)
    for drop in (True, False):
        args = (4, 12000, 8, 70)
        got = list(pds.aligned_batch_iterator(ours, *args, seed=2, num_epochs=2,
                                              drop_remainder=drop))
        want = list(jds.aligned_batch_iterator(ref, *args, seed=2, num_epochs=2,
                                               drop_remainder=drop))
        assert len(got) == len(want) == (6 if drop else 8)
        for g, w in zip(got, want):
            assert all(np.array_equal(p, q) and p.dtype == q.dtype for p, q in zip(g, w))


def test_kaldi_alignment_tables_match_jax_both_ways(tmp_path):
    rng = np.random.RandomState(1)
    recs = [(f"utt{i}", rng.randint(0, 40, n).tolist()) for i, n in enumerate((7, 0, 130))]
    for tag, write in (("port", kaldi.write_ali_ark), ("jax", jkaldi.write_ali_ark)):
        write(str(tmp_path / tag / "ali"), recs)
    assert (tmp_path / "port/ali.ark").read_bytes() == (tmp_path / "jax/ali.ark").read_bytes()
    for tag in ("port", "jax"):
        for ext in ("ark", "scp"):
            path = str(tmp_path / tag / f"ali.{ext}")
            got, want = list(kaldi.iter_ali(path)), list(jkaldi.iter_ali(path))
            assert [k for k, _ in got] == [k for k, _ in want] == [k for k, _ in recs]
            for (_, g), (_, w), (_, r) in zip(got, want, recs):
                assert g.dtype == w.dtype == np.int32 and g.tolist() == w.tolist() == r
    # an scp relative to its own directory, and text-mode vectors
    (tmp_path / "port/rel.scp").write_text(
        (tmp_path / "port/ali.scp").read_text().replace(str(tmp_path / "port") + "/", ""))
    assert [v.tolist() for _, v in kaldi.iter_ali(str(tmp_path / "port/rel.scp"))] == \
        [r for _, r in recs]
    (tmp_path / "text.ark").write_bytes(b"a 1 2 3\nb 4\n")
    got = [(k, v.tolist()) for k, v in kaldi.iter_ali(str(tmp_path / "text.ark"))]
    assert got == [(k, v.tolist()) for k, v in jkaldi.iter_ali(str(tmp_path / "text.ark"))]
    with open(tmp_path / "port/ali.ark", "rb") as f:
        kaldi._seek_key(f, "utt2")
        assert kaldi.read_int_vector(f).tolist() == recs[2][1]
        f.seek(0)
        with pytest.raises(KeyError, match="nope"):
            kaldi._seek_key(f, "nope")


@pytest.mark.parametrize("phone_map", [False, True])
def test_prepare_import_ali_matches_jax(tmp_path, phone_map):
    vocab = ["<blk>", "aa", "b", "k", "<unk>"]
    (tmp_path / "vocab.txt").write_text("\n".join(vocab) + "\n")
    (tmp_path / "list.tsv").write_text("u1\ta.wav\taa b\nu2\tb.wav\tk\n\nu3\tc.wav\t\n")
    rng = np.random.RandomState(2)
    recs = [(u, rng.randint(1, 4, n).tolist()) for u, n in (("u3", 5), ("u1", 9), ("u2", 1))]
    extra = []
    if phone_map:  # Kaldi ids 10, 11, 12 for aa, b, k
        recs = [(u, [9 + i for i in ids]) for u, ids in recs]
        (tmp_path / "phones.txt").write_text("<eps> 0\naa 10\nb 11\nk 12\n")
        extra = ["--phone-map", str(tmp_path / "phones.txt")]
    kaldi.write_ali_ark(str(tmp_path / "ali"), recs)
    for ext in ("ark", "scp"):
        args = ["import-ali", "--ali", str(tmp_path / f"ali.{ext}"), "--list",
                str(tmp_path / "list.tsv"), "--vocab", str(tmp_path / "vocab.txt"), *extra]
        assert prepare.main([*args, "--out", str(tmp_path / "port.tsv")]) == 0
        assert jax_prepare.main([*args, "--out", str(tmp_path / "jax.tsv")]) == 0
        assert (tmp_path / "port.tsv").read_bytes() == (tmp_path / "jax.tsv").read_bytes()
        utts = read_utterance_list(str(tmp_path / "port.tsv"))
        assert [len(u.align_tokens) for u in utts] == [9, 1, 5]
    kaldi.write_ali_ark(str(tmp_path / "bad"), [("u1", [99])])
    for main in (prepare.main, jax_prepare.main):
        with pytest.raises(SystemExit, match="has no symbol"):
            main(["import-ali", "--ali", str(tmp_path / "bad.ark"), "--list",
                  str(tmp_path / "list.tsv"), "--vocab", str(tmp_path / "vocab.txt"), "--out",
                  str(tmp_path / "x.tsv")])


# (model, frontend): the classifier at frontend downsample 3 takes every
# 3rd frame label; conv_bigru's two stride-2 convs every 4th
STEP_CASES = {
    "classifier": (dict(encoder="classifier", classifier_hidden=16, classifier_layers=2,
                        classifier_context=1), dict(num_mel_bins=16, downsample=3)),
    "conv_bigru": (dict(encoder="conv_bigru", hidden_size=8, num_gru_layers=2, conv_channels=4),
                   dict(num_mel_bins=16)),
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_three_frame_ce_steps_match_jax(case):
    model, front = STEP_CASES[case]
    examples, vocab = pds.make_synthetic_dataset(num_utts=12, num_phones=6, seed=3,
                                                 with_alignments=True)
    batches = list(itertools.islice(pds.aligned_batch_iterator(examples, 4, 16000, 8, 98,
                                                               seed=1), 3))
    train_kw = dict(mode="frame_ce", lr=3e-3, lr_schedule="constant", total_steps=3)
    jcfg = JaxConfig(frontend=JaxFrontendConfig(**front), model=JaxModelConfig(**model),
                     train=JaxTrainConfig(**train_kw), vocab_size=len(vocab))
    jtrainer = jax_train.CTCTrainer(jcfg)
    feats, flen = jtrainer._feats(batches[0].audio, batches[0].audio_lengths)
    params = jax.jit(jtrainer.model.init)(jax.random.PRNGKey(0), feats, flen)
    jstate = jax_train.TrainState(jnp.zeros((), jnp.int32), params,
                                  jtrainer.optimizer.init(params))
    pcfg = tc.Config(frontend=tc.FrontendConfig(**front),
                     model=tc.ModelConfig(gru_pallas=True, **model),
                     train=tc.TrainConfig(**train_kw), vocab_size=len(vocab))
    trainer = train.CTCTrainer(pcfg, device="cpu")
    trainer.model.load_state_dict(flax_to_state_dict(jax.tree.map(np.asarray, params), pcfg))
    state = trainer.init_state()
    step_fn = jtrainer.jitted_train_step()
    for b in batches:
        jstate, jaux = step_fn(jstate, jds.AlignedBatch(*map(jnp.asarray, b)),
                               jax.random.PRNGKey(1))
        state, aux = trainer.train_step(state, b)
        for k in ("loss", "frame_acc", "grad_norm"):
            np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=1e-4, err_msg=k)
    assert 0 < float(aux["frame_acc"]) <= 1
    want = flax_to_state_dict(jax.tree.map(np.asarray, jstate.params), pcfg)
    assert set(want) == set(state.params)
    for k, v in want.items():
        np.testing.assert_allclose(state.params[k].detach().numpy(), v.numpy(), atol=1e-4,
                                   rtol=0, err_msg=k)
    with pytest.raises(TypeError, match="AlignedBatch"):
        trainer.train_step(state, b[:4])


def test_cli_trains_decodes_and_aligns_frame_ce(tmp_path, capsys):
    """``prepare synth --align`` -> ``--set train.mode=frame_ce`` from the
    lists (read into memory with their tracks) with dev eval -> ``--mode
    infer`` -> ``tools.align`` on the frame-CE checkpoint, each alignment
    collapsing to its transcript; the synthetic corpus trains the same
    way; a feature cache exits."""
    recipe = str(REPO_CONFIGS / "synthetic_smoke.yaml")
    d = tmp_path / "corp"
    assert prepare.main(["synth", "--out-dir", str(d), "--num-utts", "24", "--num-phones",
                         "8", "--align"]) == 0
    lists = ["--set", "data.synthetic=false", "--set", f"data.train_list={d / 'train.tsv'}",
             "--set", f"data.dev_list={d / 'dev.tsv'}", "--set",
             f"data.test_list={d / 'dev.tsv'}", "--set", f"data.vocab_path={d / 'vocab.txt'}"]
    common = ["-c", recipe, "--device", "cpu", "--set", "train.mode=frame_ce", "--set",
              f"model_dir={tmp_path / 'exp'}", *lists]
    assert cli.main([*common, "--mode", "train", "--set", "train.total_steps=8", "--set",
                     "train.log_every=4", "--set", "train.eval_every=8"]) == 0
    recs = [__import__("json").loads(ln) for ln in
            (tmp_path / "exp" / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs if r["tag"] == "train"] == [4, 8]
    assert all(0 <= r["frame_acc"] <= 1 for r in recs if r["tag"] == "train")
    assert np.isfinite([r["per"] for r in recs if r["tag"] == "dev"]).all()
    capsys.readouterr()
    assert cli.main([*common, "--mode", "infer"]) == 0
    assert capsys.readouterr().out.startswith("step 8: PER=")
    out = tmp_path / "aligned.tsv"
    assert align.main(["-c", recipe, "--device", "cpu", "--split", "dev", "--out", str(out),
                       "--set", "train.mode=frame_ce", "--set",
                       f"model_dir={tmp_path / 'exp'}", *lists]) == 0
    vocab = load_vocab(str(d / "vocab.txt"))
    utts = read_utterance_list(str(out))
    assert len(utts) == 3
    for u in utts:
        track = vocab.encode(u.align_tokens)[::2]  # cnn stride 2
        merged = [t for i, t in enumerate(track) if t != 0 and (i == 0 or t != track[i - 1])]
        assert merged == vocab.encode(u.tokens)
    assert cli.main(["-c", recipe, "--device", "cpu", "--mode", "train", "--set",
                     "train.mode=frame_ce", "--set", "train.total_steps=2", "--set",
                     f"model_dir={tmp_path / 'syn'}"]) == 0
    with pytest.raises(SystemExit, match="feature caches carry none"):
        cli.main(["-c", recipe, "--device", "cpu", "--set", "train.mode=frame_ce", "--set",
                  f"data.feature_cache={tmp_path}", "--set", f"model_dir={tmp_path / 'x'}"])


def test_aligned_batches_pad_the_track_to_the_cap():
    cfg = tc.Config(data=tc.DataConfig(batch_size=3, max_audio_seconds=1.0,
                                       bucket_boundaries=(0.5, 1.0)))
    examples, _ = pds.make_synthetic_dataset(num_utts=5, num_phones=4, seed=1,
                                             with_alignments=True)
    got = list(cli._batches(cfg, ("examples", examples), num_epochs=1, drop_remainder=False))
    assert [len(b.audio) for b in got] == [3, 2]
    for b in got:
        # no buckets: every batch pads to the 1 s cap, its track to 98 frames
        assert isinstance(b, pds.AlignedBatch) and b.audio.shape[1] == 16000
        assert b.frame_labels.shape[1] == 98 and (b.frame_labels[:, -1] == -1).any()
    lifted = cli._lift_caps_for_split(cfg, ("examples", examples))
    assert lifted.data.max_audio_seconds == max(
        cfg.data.max_audio_seconds, max(len(a) for a, _, _ in examples) / 16000)
    assert dataclasses.asdict(lifted.model) == dataclasses.asdict(cfg.model)
