"""LM and HMM decode end to end on the CPU, the port against the JAX
package on the same weights and tables: ``run_inference`` with
``ctc.use_viterbi`` and with the ``ctc.lm_path`` beam (bigram and
trigram; JAX's beam through the Pallas kernel in interpret mode), a
generator's Viterbi decode through ``GeneratorInfer.logits_fn`` (the
dwell rates calibrated on the merged stream), ``StreamingRecognizer``'s
beam with a bigram and a trigram table, ``tools.align.align_list``, and
the CLI's ``--mode infer`` with the overrides.

Sizes: conv_bigru H = 16, V = 8, two batches of 8; the streaming cnn H =
32, V = 10, three streams. Bars: PER, error counts, hypothesis files and
streamed ids equal; the aligned list byte-equal, its mean path log-prob
rtol 1e-5."""

import dataclasses
import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests._torch_unsup_cases import REPO
from tests._torch_unsup_cases import cfgs as unsup_cfgs
from tests._torch_unsup_cases import corpus as unsup_corpus
from uasr import train as jax_train
from uasr.checkpoint import CheckpointManager as JaxCheckpointManager
from uasr.config import Config as JaxConfig
from uasr.config import CTCConfig as JaxCTCConfig
from uasr.config import DataConfig as JaxDataConfig
from uasr.config import FrontendConfig as JaxFrontendConfig
from uasr.config import ModelConfig as JaxModelConfig
from uasr.config import TrainConfig as JaxTrainConfig
from uasr.data.dataset import batch_iterator, make_synthetic_dataset
from uasr.infer import run_inference as jax_run_inference
from uasr.models.models import build_model as jax_build_model
from uasr.ops import lm as jlm
from uasr.serve import StreamingRecognizer as JaxRecognizer
from uasr.tools.align import align_list as jax_align_list
from uasr_torch import cli, infer, train
from uasr_torch import config as tc
from uasr_torch.checkpoint import CheckpointManager
from uasr_torch.convert import flax_to_state_dict
from uasr_torch.data.dataset import batch_iterator as port_batches
from uasr_torch.data.io import write_wav
from uasr_torch.frontend.features import compute_features, make_frontend_state
from uasr_torch.models.models import build_discriminator, build_model
from uasr_torch.ops import viterbi
from uasr_torch.ops.decode import ctc_beam_search_decode
from uasr_torch.serve import StreamingRecognizer
from uasr_torch.tools.align import align_list
from uasr_torch.vocab import Vocab

FRONTEND = dict(num_mel_bins=24)
MODEL = dict(encoder="conv_bigru", hidden_size=16, num_gru_layers=2, conv_channels=4)
DATA = dict(batch_size=8, max_audio_seconds=2.0, max_label_len=16)
LM = dict(lm_weight=0.5, lm_bonus=0.3)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Seeded conv_bigru weights, a corpus, its bigram and trigram tables
    (`prepare lm`'s builds), and each package's checkpoint of the weights."""
    root = tmp_path_factory.mktemp("lm_decode")
    examples, vocab = make_synthetic_dataset(num_utts=16, num_phones=6, seed=6)
    V = len(vocab)
    jcfg = JaxConfig(model_dir=str(root / "jax"), frontend=JaxFrontendConfig(**FRONTEND),
                     model=JaxModelConfig(**MODEL), data=JaxDataConfig(**DATA),
                     train=JaxTrainConfig(total_steps=1), vocab_size=V)
    trainer = jax_train.CTCTrainer(jcfg)
    first = next(iter(batch_iterator(examples, 8, 16000, 8, shuffle=False)))
    state = jit_init_state(trainer, jax.random.PRNGKey(0), first)
    seqs = [ids for _, ids in examples]
    tables = {}
    for order, build in ((2, jlm.build_bigram_lm), (3, jlm.build_trigram_lm)):
        tables[order] = str(root / f"lm{order}.npz")
        jlm.save_lm(tables[order], build(seqs, V, exclude=(0,)))
    return dict(root=root, examples=examples, vocab=vocab, jcfg=jcfg, trainer=trainer,
                state=state, tables=tables)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this file: the suite runs files in parallel
    workers, and under that load each of the many small parallel ops here
    waits on every thread of an oversubscribed pool (tens of times slower)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def jit_init_state(trainer, rng, example):
    """``CTCTrainer.init_state`` with the model's init jitted: the same
    parameters, without the seconds of its op-by-op trace."""
    feats, flen = trainer._feats(example.audio, example.audio_lengths)
    params = jax.jit(trainer.model.init)(rng, feats, flen)
    return jax_train.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                opt_state=trainer.optimizer.init(params))


def _batches(examples):
    return itertools.islice(batch_iterator(examples, 8, 16000, 8, shuffle=False), 2)


def _port_cfg(jcfg, ctc_kw, **extra):
    extra = {"model_dir": jcfg.model_dir, **extra}
    return tc.Config(frontend=tc.FrontendConfig(**FRONTEND),
                     model=tc.ModelConfig(gru_pallas=True, **MODEL),
                     data=tc.DataConfig(**DATA), ctc=tc.CTCConfig(**ctc_kw),
                     vocab_size=jcfg.vocab_size, **extra)


def _port_model(cfg, params):
    model = build_model(cfg.model, cfg.dim_output, cfg.frontend.dim_input, device="cpu")
    model.load_state_dict(flax_to_state_dict(jax.tree.map(np.asarray, params), cfg))
    return model


@pytest.mark.parametrize("order", [2, 3], ids=["bigram", "trigram"])
@pytest.mark.parametrize("mode", ["viterbi", "beam"])
def test_run_inference_with_lm_matches_jax(trained, mode, order, tmp_path, monkeypatch):
    monkeypatch.setenv("UASR_PALLAS_BEAM", "interpret")
    t = trained
    ctc_kw = dict(lm_path=t["tables"][order], beam_width=4, **LM,
                  **({"use_viterbi": True} if mode == "viterbi" else {"use_beam": True}))
    jcfg = dataclasses.replace(t["jcfg"], ctc=JaxCTCConfig(**ctc_kw))
    j_hyp, t_hyp = tmp_path / "jax_hyp.txt", tmp_path / "torch_hyp.txt"
    ref = jax_run_inference(jcfg, t["trainer"], t["state"], _batches(t["examples"]),
                            vocab=t["vocab"], hyp_path=str(j_hyp))
    cfg = _port_cfg(jcfg, ctc_kw)
    got = infer.run_inference(cfg, _port_model(cfg, t["state"].params),
                              make_frontend_state(cfg.frontend, device="cpu"),
                              _batches(t["examples"]),
                              vocab=Vocab(tokens=t["vocab"].tokens, blank_id=0),
                              hyp_path=str(t_hyp), device="cpu")
    for key in ("errors", "ref_tokens", "audio_seconds", "per"):
        assert got[key] == ref[key], key
    assert t_hyp.read_text() == j_hyp.read_text()
    assert infer.LAST_BEAM_IMPL == ("reference" if mode == "beam" else None)


def test_generator_viterbi_calibrates_on_the_merged_stream(tmp_path, monkeypatch):
    """A merge_repeats generator decoded with ctc.use_viterbi through
    GeneratorInfer.logits_fn: the probe and the decode both see the merged
    stream (its calibrated self_loop is near 0, not the frame stream's
    0.75), and PER and hypotheses equal JAX's."""
    examples, vocab = unsup_corpus(12, seed=2)
    lm = str(tmp_path / "lm.npz")
    jlm.save_lm(lm, jlm.build_bigram_lm([ids for _, ids in unsup_corpus()[0]], len(vocab),
                                        exclude=(0,)))
    jc, pc = unsup_cfgs("bce_eodm", tmp_path, len(vocab))
    jc = dataclasses.replace(jc, ctc=JaxCTCConfig(use_viterbi=True, lm_path=lm))
    pc = dataclasses.replace(pc, ctc=tc.CTCConfig(use_viterbi=True, lm_path=lm))
    decode = list(port_batches(examples, 5, 16000, 8, shuffle=False, num_epochs=1,
                               drop_remainder=False))
    jinf = jax_train.GeneratorInfer(jc)
    jinf.frontend_state  # built eagerly: a lazy build inside jit leaks a tracer
    g_params = jax.tree.map(np.asarray, jinf.init_params(jax.random.PRNGKey(3), decode[0][0],
                                                         decode[0][1]))
    ginf = train.GeneratorInfer(pc, device="cpu")
    ginf.gen.load_state_dict(flax_to_state_dict(g_params, pc))
    jtr = jax_train.CTCTrainer(jc)
    jstate = jax_train.TrainState(0, g_params, jtr.optimizer.init(g_params))
    want = jax_run_inference(jc, jtr, jstate, iter(decode), vocab=vocab,
                             hyp_path=str(tmp_path / "j.txt"), logits_fn=jinf.logits_fn)
    rates = []
    make = viterbi.make_lm_decoder

    def recording(table, blank_id, self_loop, blank_prob, device):
        rates.append((self_loop, blank_prob))
        return make(table, blank_id, self_loop, blank_prob, device)

    monkeypatch.setattr(viterbi, "make_lm_decoder", recording)
    got = infer.run_inference(pc, ginf.gen, ginf.frontend_state, iter(decode), vocab=vocab,
                              hyp_path=str(tmp_path / "t.txt"), device="cpu",
                              logits_fn=ginf.logits_fn)
    assert (got["per"], got["errors"], got["ref_tokens"]) == (
        want["per"], want["errors"], want["ref_tokens"])
    assert (tmp_path / "t.txt").read_text() == (tmp_path / "j.txt").read_text()
    assert len(rates) == 1 and rates[0][0] < 0.3, rates


# ------------------------------------------------------------- streaming

CHUNK, SV = 32, 10
CS = CHUNK * 160


def _stream_kw(lm_path):
    return (dict(num_mel_bins=40, cmvn="streaming", streaming_chunk_frames=CHUNK),
            dict(encoder="cnn", hidden_size=32, num_conv_layers=2, conv_time_stride=2,
                 conv_kernel=5),
            dict(blank_id=0, use_beam=True, beam_width=4, lm_path=lm_path, **LM))


@pytest.fixture(scope="module")
def stream_setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("lm_stream")
    f, m, _ = _stream_kw(None)
    params = jax_build_model(JaxModelConfig(**m), SV).init(
        jax.random.PRNGKey(3), np.zeros((1, 4 * CHUNK, 40), np.float32), np.array([4 * CHUNK]))
    model = build_model(tc.ModelConfig(**m), SV, 40, device="cpu")
    model.load_state_dict(flax_to_state_dict(jax.tree.map(np.asarray, params),
                                             tc.ModelConfig(**m)))
    rng = np.random.RandomState(4)
    tables = {}
    for order in (2, 3):
        tab = np.log(rng.dirichlet(np.ones(SV), (SV + 1,) * (order - 1))).astype(np.float32)
        tables[order] = (str(root / f"lm{order}.npz"), tab)
        jlm.save_lm(tables[order][0], tab)
    lens = np.array([5 * CS, 3 * CS + 100, 2 * CS - 7])
    L = -(-int(lens.max()) // CS) * CS
    audio = (0.3 * np.random.RandomState(1).randn(len(lens), L)).astype(np.float32)
    audio[np.arange(L)[None] >= lens[:, None]] = 0.0
    return params, model, tables, audio, lens


@pytest.mark.parametrize("order", [2, 3], ids=["bigram", "trigram"])
def test_streaming_beam_with_lm_matches_jax_and_offline(stream_setup, order):
    """The carried beam with the table fused: finals equal JAX's streamed
    finals and the port's one-pass offline beam with the same table (a
    trigram's two-symbol history crosses the chunk boundaries)."""
    params, model, tables, audio, lens = stream_setup
    path, tab = tables[order]
    f, m, c = _stream_kw(path)
    jrec = JaxRecognizer(JaxConfig(name="lm_stream", frontend=JaxFrontendConfig(**f),
                                   model=JaxModelConfig(**m), ctc=JaxCTCConfig(**c),
                                   vocab_size=SV), params)
    cfg = tc.Config(name="lm_stream", frontend=tc.FrontendConfig(**f),
                    model=tc.ModelConfig(**m), ctc=tc.CTCConfig(**c), vocab_size=SV)
    rec = StreamingRecognizer(cfg, model, device="cpu")
    assert rec.lm_order == order
    js, ts = jrec.init(len(lens), lens), rec.init(len(lens), lens)
    for off in range(0, audio.shape[1], CS):
        js, _, _ = jrec.step(js, audio[:, off:off + CS])
        ts, _, _ = rec.step(ts, audio[:, off:off + CS])
    _, jids, jn = jrec.finish(js)
    _, ids, n = rec.finish(ts)
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    with torch.inference_mode():
        feats, flen = compute_features(torch.tensor(audio), torch.tensor(lens),
                                       make_frontend_state(cfg.frontend, device="cpu"),
                                       cfg.frontend)
        logits, k = model(feats, flen)
        off_ids, off_n, _ = ctc_beam_search_decode(logits, k, 4, 0, lm_logp=torch.tensor(tab),
                                                   **LM)
    for b in range(len(lens)):
        assert ids[b, : int(n[b])].tolist() == off_ids[b, : int(off_n[b])].tolist()
    assert int(n.sum()) > 0


# ------------------------------------------------------------- alignment


def test_align_list_matches_jax(trained, tmp_path, capsys, monkeypatch):
    """tools.align on the same weights restored from each package's
    checkpoint: the same four-column list and stats."""
    t = trained
    # JAX's align_list builds its restore template with init_state
    monkeypatch.setattr(jax_train.CTCTrainer, "init_state", jit_init_state)
    vocab = t["vocab"]
    (tmp_path / "vocab.txt").write_text("\n".join(vocab.tokens) + "\n")
    rows = []
    for i, (audio, ids) in enumerate(t["examples"][:10]):
        wav = str(tmp_path / "wav" / f"u{i}.wav")
        write_wav(wav, audio, 16000)
        rows.append(f"u{i}\t{wav}\t{' '.join(vocab.tokens[j] for j in ids)}\n")
    lst = tmp_path / "train.tsv"
    lst.write_text("".join(rows))
    jcfg = dataclasses.replace(t["jcfg"], data=dataclasses.replace(
        t["jcfg"].data, vocab_path=str(tmp_path / "vocab.txt")))
    mgr = JaxCheckpointManager(f"{jcfg.model_dir}/ckpt")
    mgr.save(1, t["state"])
    mgr.close()
    cfg = _port_cfg(jcfg, {}, model_dir=str(tmp_path / "torch"))
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data,
                                                            vocab_path=jcfg.data.vocab_path))
    trainer = train.CTCTrainer(cfg, device="cpu")
    trainer.model.load_state_dict(_port_model(cfg, t["state"].params).state_dict())
    CheckpointManager(f"{cfg.model_dir}/ckpt").save(1, trainer.init_state())
    want = jax_align_list(jcfg, str(lst), str(tmp_path / "jax.tsv"), batch_size=4)
    got = align_list(cfg, str(lst), str(tmp_path / "torch.tsv"), batch_size=4, device="cpu")
    assert "align: restored step 1" in capsys.readouterr().err
    assert (tmp_path / "torch.tsv").read_text() == (tmp_path / "jax.tsv").read_text()
    assert (got["utts"], got["frames"]) == (want["utts"], want["frames"]) == (10, got["frames"])
    np.testing.assert_allclose(got["mean_logp_per_frame"], want["mean_logp_per_frame"],
                               rtol=1e-5)
    with pytest.raises(SystemExit, match="CTC-trained"):
        align_list(dataclasses.replace(cfg, train=tc.TrainConfig(mode="gan")), str(lst),
                   str(tmp_path / "x.tsv"), device="cpu")


# ------------------------------------------------------------------- CLI


def test_cli_infer_with_viterbi_and_lm_beam(tmp_path, capsys, monkeypatch):
    """--mode infer with --set ctc.use_viterbi / ctc.lm_path on a CTC
    checkpoint: the overrides reach run_inference (the Viterbi decoder
    over the table, K4's table on the beam), and a GAN checkpoint's
    logits_fn runs for the probe and for every decode batch."""
    seqs = [list(np.random.RandomState(i).randint(1, 9, 6)) for i in range(20)]
    for order, build in ((2, jlm.build_bigram_lm), (3, jlm.build_trigram_lm)):
        jlm.save_lm(str(tmp_path / f"lm{order}.npz"), build(seqs, 10, exclude=(0,)))
    smoke = str(REPO / "configs" / "synthetic_smoke.yaml")
    base = ["-c", smoke, "--device", "cpu", "--set", f"model_dir={tmp_path / 'ctc'}",
            "--set", "data.synthetic_dev_utts=16"]
    cfg = tc.load_config(smoke)
    cli.apply_overrides(cfg, [f"model_dir={tmp_path / 'ctc'}"])
    trainer = train.CTCTrainer(cfg, device="cpu")
    CheckpointManager(f"{cfg.model_dir}/ckpt").save(3, trainer.init_state())
    seen = []
    decode = infer._decode_batch

    def spy(cfg, model, fstate, db, logits_fn=None, lm_table=None, viterbi_fn=None):
        seen.append((cfg.ctc.use_viterbi, cfg.ctc.use_beam,
                     None if lm_table is None else tuple(lm_table.shape), viterbi_fn is not None))
        return decode(cfg, model, fstate, db, logits_fn, lm_table, viterbi_fn)

    monkeypatch.setattr(infer, "_decode_batch", spy)
    runs = [("viterbi", 2, ["--set", "ctc.use_viterbi=true"], (True, False, None, True)),
            ("viterbi", 3, ["--set", "ctc.use_viterbi=true"], (True, False, None, True)),
            ("beam", 3, ["--set", "ctc.use_beam=true"], (False, True, (11, 11, 10), False))]
    for _, order, extra, want in runs:
        seen.clear()
        assert cli.main([*base, "--mode", "infer", "--set",
                         f"ctc.lm_path={tmp_path / f'lm{order}.npz'}", *extra]) == 0
        assert capsys.readouterr().out.startswith("step 3: PER=")
        assert seen == [want] * 2

    # a merge_repeats GAN checkpoint of the unsupervised demo recipe
    demo = str(REPO / "configs" / "synthetic_unsup_demo.yaml")
    gcfg = tc.load_config(demo)
    cli.apply_overrides(gcfg, [f"model_dir={tmp_path / 'gan'}", "model.classifier_hidden=16",
                               "model.disc_channels=8"])
    gcfg = gcfg.replace(vocab_size=8)
    ginf = train.GeneratorInfer(gcfg, device="cpu")
    gp = dict(ginf.gen.named_parameters())
    dp = dict(build_discriminator(gcfg.model, 8, device="cpu").named_parameters())
    opt = train.make_optimizer(gcfg)
    CheckpointManager(f"{gcfg.model_dir}/ckpt").save(
        5, train.GANState(0, gp, dp, opt.init(gp), opt.init(dp)))
    jlm.save_lm(str(tmp_path / "lm8.npz"), jlm.build_bigram_lm(seqs, 8, exclude=(0,)))
    calls = []
    logits_fn = train.GeneratorInfer.logits_fn

    def counting(self, audio, lengths):
        calls.append(audio.shape[0])
        return logits_fn(self, audio, lengths)

    monkeypatch.setattr(train.GeneratorInfer, "logits_fn", counting)
    seen.clear()
    assert cli.main(["-c", demo, "--device", "cpu", "--mode", "infer", "--set",
                     f"model_dir={tmp_path / 'gan'}", "--set", "model.classifier_hidden=16",
                     "--set", "model.disc_channels=8", "--set", "data.synthetic_dev_utts=48",
                     "--set", "ctc.use_viterbi=true", "--set",
                     f"ctc.lm_path={tmp_path / 'lm8.npz'}"]) == 0
    assert capsys.readouterr().out.startswith("step 5: PER=")
    # two batches (32 + 16): each probed once, then decoded
    assert calls == [32, 16, 32, 16] and seen == [(True, False, None, True)] * 2
