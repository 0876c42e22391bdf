"""Self-training on the CPU, the port against the JAX package on the same
converted weights: the GAN / EODM labeller (greedy and LM-HMM Viterbi,
with and without forced-aligned frame tracks against the raw pre-merge
posteriors), the CTC labeller (a cnn at frontend downsample 2, its tracks
repeated by 2 x 2), ``pseudo_label``'s stats and kept examples, and one
round of ``self_train`` in each flavour (a frame-CE classifier student
from the GAN teacher's weights; a CTC student from the CTC teacher's),
three steps each. Then the port's tools alone: ``tools.selftrain`` with
GAN, EODM and CTC teachers (aligned, Viterbi-refined, gold mix-in, resume,
stale students wiped, gold with aligned labels refused) and
``tools.sweep`` (the winner is the best score; a rerun trains no step),
whose winner ``--restore-best`` seeds.

Bars: ids, lengths and frame tracks bit-equal, confidences rtol 1e-5;
stats equal (mean confidence rtol 1e-5); students' parameters atol 1e-4
(f32, summation order only: JAX shards each batch of 8 over the suite's
8 CPU devices)."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from uasr import selftrain as jst
from uasr import train as jax_train
from uasr.config import Config as JaxConfig
from uasr.config import CTCConfig as JaxCTCConfig
from uasr.config import DataConfig as JaxDataConfig
from uasr.config import FrontendConfig as JaxFrontendConfig
from uasr.config import GANConfig as JaxGANConfig
from uasr.config import ModelConfig as JaxModelConfig
from uasr.config import TrainConfig as JaxTrainConfig
from uasr.data.dataset import Batch as JaxBatch
from uasr.ops import lm as jlm
from uasr.ops import viterbi as jvit
from uasr_torch import cli, selftrain, train
from uasr_torch import config as tc
from uasr_torch.convert import flax_to_state_dict
from uasr_torch.data.dataset import batch_iterator, make_synthetic_dataset
from uasr_torch.ops import viterbi
from uasr_torch.tools import selftrain as st_tool
from uasr_torch.tools import sweep

REPO_CONFIGS = __import__("pathlib").Path(__file__).resolve().parents[1] / "configs"
B = 8
GAN_MODEL = dict(encoder="classifier", classifier_hidden=16, classifier_layers=2,
                 classifier_context=1, disc_channels=8, disc_layers=2)
GAN_FRONT = dict(num_mel_bins=16, downsample=3)
CTC_MODEL = dict(encoder="cnn", hidden_size=16, num_conv_layers=2, conv_time_stride=2,
                 conv_kernel=5)
CTC_FRONT = dict(num_mel_bins=16, downsample=2)
DATA = dict(batch_size=B, max_audio_seconds=1.0, max_label_len=10)
TRAIN = dict(lr=3e-3, lr_schedule="constant", log_every=1, eval_every=1000, save_every=1000)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite runs files in parallel workers, and
    an oversubscribed pool slows the many small ops here several times."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _cfgs(kind, model_dir, V):
    model, front = (GAN_MODEL, GAN_FRONT) if kind == "gan" else (CTC_MODEL, CTC_FRONT)
    gan = dict(merge_repeats=True)
    jc = JaxConfig(model_dir=str(model_dir), frontend=JaxFrontendConfig(**front),
                   model=JaxModelConfig(**model), ctc=JaxCTCConfig(), gan=JaxGANConfig(**gan),
                   data=JaxDataConfig(**DATA), train=JaxTrainConfig(**TRAIN), vocab_size=V)
    pc = tc.Config(model_dir=str(model_dir), frontend=tc.FrontendConfig(**front),
                   model=tc.ModelConfig(**model), ctc=tc.CTCConfig(), gan=tc.GANConfig(**gan),
                   data=tc.DataConfig(**DATA), train=tc.TrainConfig(**TRAIN), vocab_size=V)
    return jc, pc


@pytest.fixture(scope="module")
def teachers(tmp_path_factory):
    """A GAN generator and a CTC model with the same weights in both
    packages (JAX's init, jitted, converted), the corpus and a bigram."""
    root = tmp_path_factory.mktemp("selftrain")
    examples, vocab = make_synthetic_dataset(num_utts=20, num_phones=6, seed=4,
                                             syntax="markov", min_len=3, max_len=7)
    V = len(vocab)
    first = next(batch_iterator(examples, B, 16000, 10, shuffle=False))
    out = dict(root=root, examples=examples, V=V,
               lm=jlm.build_bigram_lm([ids for _, ids in examples], V, exclude=(0,)))
    jc, pc = _cfgs("gan", root / "gan", V)
    jgen = jax_train.GeneratorInfer(jc)
    jgen.frontend_state  # noqa: B018  (built eagerly: a jit would cache a tracer)
    feats, flen = jgen._gen_feats(JaxBatch(*map(jnp.asarray, first)))
    g_params = jax.jit(jgen.gen.init)(jax.random.PRNGKey(1), feats, flen)
    pgen = train.GeneratorInfer(pc, device="cpu")
    pgen.gen.load_state_dict(flax_to_state_dict(jax.tree.map(np.asarray, g_params), pc))
    out["gan"] = (jc, pc, jgen, g_params, pgen)
    jc, pc = _cfgs("ctc", root / "ctc", V)
    jtr = jax_train.CTCTrainer(jc)
    feats, flen = jtr._feats(first.audio, first.audio_lengths)
    c_params = jax.jit(jtr.model.init)(jax.random.PRNGKey(2), feats, flen)
    ptr = train.CTCTrainer(pc, device="cpu")
    ptr.model.load_state_dict(flax_to_state_dict(jax.tree.map(np.asarray, c_params), pc))
    out["ctc"] = (jc, pc, jtr, c_params, ptr)
    return out


def _labellers(teachers, kind, hmm, align):
    jc, pc, jt, params, pt = teachers[kind]
    jhmm = phmm = None
    if hmm:
        jhmm = jvit.make_lm_decoder(teachers["lm"], 0, self_loop=0.5, blank_prob=0.2)
        phmm = viterbi.make_lm_decoder(teachers["lm"], 0, self_loop=0.5, blank_prob=0.2)
    if kind == "gan":
        return (jst.make_gan_label_fn(jt, params, hmm=jhmm, align_frames=align),
                selftrain.make_gan_label_fn(pt, hmm=phmm, align_frames=align))
    return (jst.make_ctc_label_fn(jt, params, hmm=jhmm, align_frames=align),
            selftrain.make_ctc_label_fn(pt, hmm=phmm, align_frames=align))


@pytest.mark.parametrize("kind", ["gan", "ctc"])
@pytest.mark.parametrize("hmm", [False, True], ids=["greedy", "viterbi"])
@pytest.mark.parametrize("align", [False, True], ids=["ids", "aligned"])
def test_label_fns_match_jax(teachers, kind, hmm, align):
    jfn, pfn = _labellers(teachers, kind, hmm, align)
    for b in batch_iterator(teachers["examples"], B, 16000, 10, shuffle=False,
                            drop_remainder=False, num_epochs=1):
        want = [np.asarray(x) for x in jfn(JaxBatch(*map(jnp.asarray, b)))]
        got = [x.numpy() for x in pfn(b)]
        assert len(got) == len(want) == (5 if align else 3)
        np.testing.assert_allclose(got[2], want[2], rtol=1e-5)
        hyps, hyp_len = got[0], got[1]
        assert np.array_equal(hyp_len, want[1])
        for i, n in enumerate(hyp_len):
            assert np.array_equal(hyps[i, :n], want[0][i, :n])
        if align:
            assert np.array_equal(got[4], want[4])
            stride = 1 if kind == "gan" else 4
            assert got[3].shape[1] == want[3].shape[1] and got[3].shape[1] % stride == 0
            for i, n in enumerate(got[4]):
                assert np.array_equal(got[3][i, :n], want[3][i, :n])
                tr = got[3][i, :n:stride]
                merged = [t for j, t in enumerate(tr) if t != 0 and (j == 0 or t != tr[j - 1])]
                assert merged == hyps[i, : hyp_len[i]].tolist()


def test_pseudo_label_matches_jax(teachers):
    jfn, pfn = _labellers(teachers, "gan", False, True)
    args = (teachers["examples"], B, 16000, 10)
    _, probe = selftrain.pseudo_label(pfn, *args)
    thr = probe["mean_conf"]  # keeps some, drops some
    got, gs = selftrain.pseudo_label(pfn, *args, conf_threshold=thr)
    want, ws = jst.pseudo_label(jfn, *args, conf_threshold=thr)
    assert 0 < gs["labeled"] < gs["total"] == ws["total"] == 20
    np.testing.assert_allclose(gs.pop("mean_conf"), ws.pop("mean_conf"), rtol=1e-5)
    assert gs == ws
    for (a, i, t), (b, j, u) in zip(got, want):
        assert np.array_equal(a, b) and i == j and t == u


@pytest.mark.parametrize("flavour", ["gan_aligned", "ctc"])
def test_one_self_train_round_matches_jax(teachers, tmp_path, flavour, monkeypatch):
    # JAX's self_train seeds round 0 from init_params without init_state, so
    # its student's lazy frontend state would first be built inside the
    # jitted step and leak a tracer into the next step: build it eagerly
    init = jax_train.CTCTrainer.__init__

    def eager_init(self, *a, **k):
        init(self, *a, **k)
        self.frontend_state  # noqa: B018

    monkeypatch.setattr(jax_train.CTCTrainer, "__init__", eager_init)
    kind = "gan" if flavour == "gan_aligned" else "ctc"
    jc, pc, _, params, pt = teachers[kind]
    jfn, pfn = _labellers(teachers, kind, False, flavour == "gan_aligned")
    jc = jc.replace(model_dir=str(tmp_path / "jax"))
    pc = pc.replace(model_dir=str(tmp_path / "port"))
    _, jstate, jh = jst.self_train(jc, jfn, teachers["examples"], steps_per_round=3,
                                   init_params=params, log=lambda *_: None)
    trainer, state, ph = selftrain.self_train(
        pc, pfn, teachers["examples"], steps_per_round=3, log=lambda *_: None, device="cpu",
        init_params={k: v.clone() for k, v in pt.model.state_dict().items()})
    assert trainer.cfg.train.mode == ("frame_ce" if kind == "gan" else "ctc")
    assert state.step == 3 and ph[0]["labeled"] == jh[0]["labeled"] == 20
    assert (tmp_path / "port/selftrain_r0/ckpt/3.pt").exists()
    if kind == "gan":
        recs = [json.loads(ln) for ln in
                (tmp_path / "port/selftrain_r0/metrics.jsonl").read_text().splitlines()]
        assert [r["step"] for r in recs if "frame_acc" in r] == [1, 2, 3]
    want = flax_to_state_dict(jax.tree.map(np.asarray, jstate.params), pc)
    for k, v in want.items():
        np.testing.assert_allclose(state.params[k].detach().numpy(), v.numpy(), atol=1e-4,
                                   rtol=0, err_msg=k)
    # [T, D] feature examples (an SSL feature cache's): the same labeller with
    # the frontend bypassed, then one student step over them
    feats = [(np.random.RandomState(i).randn(40, 16).astype(np.float32), [1]) for i in range(B)]
    _, fstate, fh = selftrain.self_train(pc.replace(model_dir=str(tmp_path / "feats")), pfn,
                                         feats, steps_per_round=1, log=lambda *_: None,
                                         device="cpu")
    assert fstate.step == 1 and fh[0]["total"] == B and fh[0]["labeled"] > 0


# the port's tools on tiny recipes trained through the port's CLI
UNSUP = ["-c", str(REPO_CONFIGS / "synthetic_unsup_demo.yaml"), "--device", "cpu",
         "--set", "data.synthetic_num_utts=16", "--set", "data.batch_size=8",
         "--set", "model.classifier_hidden=16", "--set", "model.disc_channels=8",
         "--set", "eodm.top_k=16", "--set", "train.log_every=1"]
SMOKE = ["-c", str(REPO_CONFIGS / "synthetic_smoke.yaml"), "--device", "cpu",
         "--set", "data.synthetic_num_utts=16", "--set", "model.hidden_size=16",
         "--set", "train.log_every=1"]


@pytest.fixture(scope="module")
def tool_teachers(tmp_path_factory):
    root = tmp_path_factory.mktemp("tools")
    for name, argv in (("gan", UNSUP), ("eodm", [*UNSUP, "--set", "train.mode=eodm"]),
                       ("ctc", SMOKE)):
        assert cli.main([*argv, "--mode", "train", "--set", "train.total_steps=2",
                         "--set", f"model_dir={root / name}"]) == 0
    examples, vocab = make_synthetic_dataset(num_utts=16, num_phones=6, seed=0,
                                             syntax="markov", min_len=4, max_len=10)
    (root / "text.txt").write_text(
        "".join(" ".join(vocab.tokens[i] for i in ids) + "\n" for _, ids in examples))
    (root / "vocab.txt").write_text("\n".join(vocab.tokens) + "\n")
    from uasr_torch.tools import prepare

    assert prepare.main(["lm", "--text", str(root / "text.txt"), "--vocab",
                         str(root / "vocab.txt"), "--out", str(root / "lm.npz")]) == 0
    return root


def _selftrain(argv, teacher, out, *extra):
    return st_tool.main([*argv, "--teacher-dir", str(teacher), "--student-steps", "2",
                         "--set", f"model_dir={out}", *extra])


def test_selftrain_tool_teachers_resume_and_wipe(tool_teachers, tmp_path, capsys):
    root = tool_teachers
    out = tmp_path / "st"
    aligned = ["--teacher-mode", "gan", "--align-pseudo-labels", "--init-from-teacher",
               "--rounds", "2"]
    assert _selftrain(UNSUP, root / "gan", out, *aligned) == 0
    res = capsys.readouterr()
    assert "student initialized from the teacher" in res.err
    assert "teacher PER=" in res.out and "(2 rounds)" in res.out
    for r in (0, 1):
        assert (out / f"selftrain_r{r}/ckpt/2.pt").exists()
        recs = (out / f"selftrain_r{r}/metrics.jsonl").read_text()
        assert recs.count("frame_acc") == 2
    # the same settings resume the finished students (no step trained)
    before = (out / "selftrain_r1/metrics.jsonl").read_text()
    assert _selftrain(UNSUP, root / "gan", out, *aligned) == 0
    res = capsys.readouterr()
    assert "existing student checkpoint found" in res.out and "wiped" not in res.err
    assert (out / "selftrain_r1/metrics.jsonl").read_text() == before
    # a new threshold wipes them
    assert _selftrain(UNSUP, root / "gan", out, *aligned, "--conf-threshold", "0.01") == 0
    assert "wiped" in capsys.readouterr().err
    # gold utterances carry no track: refused with aligned labels
    from uasr_torch.tools import prepare

    assert prepare.main(["synth", "--out-dir", str(tmp_path / "g8"), "--num-utts", "9",
                         "--num-phones", "8"]) == 0
    gold = str(tmp_path / "g8" / "train.tsv")
    with pytest.raises(ValueError, match="gold mix-in"):
        _selftrain(UNSUP, root / "gan", tmp_path / "g", "--align-pseudo-labels", "--gold-list",
                   gold)
    # an EODM teacher with Viterbi-refined labels; a CTC teacher with gold
    assert _selftrain(UNSUP, root / "eodm", tmp_path / "e", "--teacher-mode", "eodm",
                      "--set", "ctc.use_viterbi=true", "--set",
                      f"ctc.lm_path={root / 'lm.npz'}") == 0
    assert "Viterbi rates calibrated" in capsys.readouterr().err
    assert _selftrain(SMOKE, root / "ctc", tmp_path / "c", "--teacher-mode", "ctc",
                      "--init-from-teacher", "--gold-list", gold) == 0
    assert (tmp_path / "c/selftrain_r0/ckpt/2.pt").exists()
    with pytest.raises(SystemExit, match="needs the student to keep"):
        _selftrain(UNSUP, root / "gan", tmp_path / "x", "--init-from-teacher", "--set",
                   "model.encoder=cnn")


def test_sweep_picks_the_best_score_and_skips_finished_seeds(tool_teachers, tmp_path, capsys):
    root = tool_teachers
    argv = [*UNSUP, "--seeds", "2", "--set", f"model_dir={tmp_path / 'sw'}", "--set",
            "train.total_steps=2", "--set", "train.eval_every=2", "--set",
            f"gan.select_lm_path={root / 'lm.npz'}"]
    assert sweep.main(argv) == 0
    rec = json.loads((tmp_path / "sw/sweep.json").read_text())
    scores = [json.loads((tmp_path / f"sw/seed{s}/best_ckpt/score.json").read_text())["score"]
              for s in (0, 1)]
    assert rec["winner"]["seed"] == int(np.argmax(scores))
    assert [r["score"] for r in rec["ranking"]] == sorted(scores, reverse=True)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == rec["winner"]
    metrics = [(tmp_path / f"sw/seed{s}/metrics.jsonl").read_text() for s in (0, 1)]
    assert sweep.main(argv) == 0
    assert [(tmp_path / f"sw/seed{s}/metrics.jsonl").read_text() for s in (0, 1)] == metrics
    assert json.loads((tmp_path / "sw/sweep.json").read_text()) == rec
    assert _selftrain(UNSUP, rec["winner"]["model_dir"], tmp_path / "best", "--restore-best",
                      "--teacher-mode", "gan") == 0
    assert "best_ckpt (step 2)" in capsys.readouterr().err
    with pytest.raises(SystemExit, match="select_lm_path"):
        sweep.main([*UNSUP, "--set", f"model_dir={tmp_path / 'n'}"])
