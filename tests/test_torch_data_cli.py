"""The port's CLI trained and decoded straight from utterance lists on
disk (``prepare synth``), in process on the CPU: ``data.streaming`` at
its default streams each split through ``StreamingASRDataset``; with
``--set data.streaming=false`` the lists are read into memory. The
stream's batches, EODM text and lifted dev caps equal the JAX CLI's."""

import dataclasses
import pathlib

import numpy as np
import pytest

from uasr import cli as jax_cli
from uasr.config import load_config as jax_load_config
from uasr_torch import cli
from uasr_torch.config import load_config
from uasr_torch.data import dataset, loader
from uasr_torch.tools import prepare

CONFIGS = pathlib.Path(__file__).resolve().parents[1] / "configs"
SMOKE = str(CONFIGS / "synthetic_smoke.yaml")
DEMO = str(CONFIGS / "synthetic_unsup_demo.yaml")


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """``prepare synth``: 40 utterances of 8 phones (35 train, 5 dev) with
    their sidecars, and 40 of a 6-phone Markov language for the GAN."""
    root = tmp_path_factory.mktemp("synth")
    assert prepare.main(["synth", "--out-dir", str(root / "smoke"), "--num-utts", "40",
                         "--num-phones", "8"]) == 0
    assert prepare.main(["synth", "--out-dir", str(root / "markov"), "--num-utts", "40",
                         "--num-phones", "6", "--syntax", "markov", "--min-len", "4"]) == 0
    return root


def _lists(d: pathlib.Path) -> list[str]:
    return ["--set", "data.synthetic=false", "--set", f"data.train_list={d / 'train.tsv'}",
            "--set", f"data.dev_list={d / 'dev.tsv'}", "--set", f"data.test_list={d / 'dev.tsv'}",
            "--set", f"data.vocab_path={d / 'vocab.txt'}"]


def _cfgs(d: pathlib.Path, *overrides: str):
    sets = [s for s in _lists(d) if s != "--set"] + list(overrides)
    cfg, jcfg = load_config(SMOKE), jax_load_config(SMOKE)
    cli.apply_overrides(cfg, sets)
    jax_cli.apply_overrides(jcfg, sets)
    return cfg, jcfg


@pytest.fixture
def count_reads(monkeypatch):
    """Calls of the in-memory reader and of the streaming loader's decode."""
    calls = {"example": 0, "stream": 0}
    example, decode = dataset.ASRDataset.example, loader.StreamingASRDataset._decode

    def counted_example(self, i):
        calls["example"] += 1
        return example(self, i)

    def counted_decode(self, *a, **k):
        calls["stream"] += 1
        return decode(self, *a, **k)

    monkeypatch.setattr(dataset.ASRDataset, "example", counted_example)
    monkeypatch.setattr(loader.StreamingASRDataset, "_decode", counted_decode)
    return calls


def test_train_and_infer_streamed_from_disk(synth, tmp_path, capsys, count_reads):
    args = ["-c", SMOKE, "--device", "cpu", "--set", f"model_dir={tmp_path}", *_lists(
        synth / "smoke"), "--set", "train.log_every=4", "--set", "train.total_steps=8"]
    assert cli.main(args) == 0
    out = capsys.readouterr().out
    assert "[train] step 4:" in out and "[train] step 8:" in out
    assert count_reads["example"] == 0 and count_reads["stream"] >= 8
    assert cli.main(args + ["--mode", "infer"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("step 8: PER=") and "PER_folded" not in out
    assert len((tmp_path / "hyp.txt").read_text().splitlines()) == 5
    assert count_reads["example"] == 0


def test_streaming_false_reads_the_lists_into_memory(synth, tmp_path, capsys, count_reads):
    args = ["-c", SMOKE, "--device", "cpu", "--set", f"model_dir={tmp_path}",
            *_lists(synth / "smoke"), "--set", "data.streaming=false",
            "--set", "train.total_steps=2", "--set", "train.log_every=2"]
    assert cli.main(args) == 0
    assert "[train] step 2:" in capsys.readouterr().out
    assert count_reads == {"example": 35 + 5, "stream": 0}  # train, then dev for dev eval
    assert cli.main(args + ["--mode", "infer"]) == 0
    assert capsys.readouterr().out.startswith("step 2: PER=")
    assert count_reads["stream"] == 0


def test_gan_eodm_streams_audio_and_its_text_with_a_labeled_mix_in(synth, tmp_path, capsys,
                                                                   count_reads):
    """The unlabeled split and its transcripts (the unpaired text) from the
    stream; the labeled mix-in split read into memory."""
    d = synth / "markov"
    args = ["-c", DEMO, "--device", "cpu", "--set", f"model_dir={tmp_path}", *_lists(d),
            "--set", f"data.labeled_list={d / 'dev.tsv'}", "--set", "gan.supervised_weight=0.5",
            "--set", "data.batch_size=8", "--set", "train.total_steps=2",
            "--set", "train.log_every=2"]
    assert cli.main(args) == 0
    assert "[train] step 2:" in capsys.readouterr().out
    assert count_reads["example"] == 5 and count_reads["stream"] >= 2
    assert cli.main(args + ["--mode", "infer"]) == 0
    assert capsys.readouterr().out.startswith("step 2: PER=")


def test_stream_source_batches_and_text_equal_jax(synth):
    d = synth / "smoke"
    cfg, jcfg = _cfgs(d, "data.shuffle_buffer=9", "data.loader_threads=2",
                      "data.bucket_boundaries=0.8,1.2,1.6")
    (kind, ds), vocab = cli._load_source(cfg, "train")
    (jkind, jds), jvocab = jax_cli._load_source(jcfg, "train")
    assert kind == jkind == "stream" and len(ds) == 35
    assert cli._load_text(cfg, (kind, ds), vocab) == jax_cli._load_text(jcfg, (jkind, jds),
                                                                         jvocab)
    got = list(cli._batches(cfg, (kind, ds), num_epochs=2, seed=4))
    want = list(jax_cli._batches(jcfg, (jkind, jds), num_epochs=2, seed=4))
    assert len(got) == len(want) > 4
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    # a full shuffle (shuffle_buffer >= N) batches as the in-memory path does
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, shuffle_buffer=4096))
    ads = dataset.ASRDataset.from_file(str(d / "train.tsv"), vocab)
    mem = ("examples", [ads.example(i) for i in range(len(ads))])
    got, want = list(cli._batches(cfg, (kind, ds), num_epochs=1)), list(cli._batches(cfg, mem,
                                                                                     num_epochs=1))
    assert len(got) == len(want) > 2
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("overrides", [
    ("data.max_audio_seconds=0.6", "data.max_label_len=4", "data.bucket_boundaries=0.3,0.5"),
    ("data.max_audio_seconds=1.0", "data.bucket_boundaries=0.4,0.8,1.0,4.0"),
    ("data.max_audio_seconds=8.0",),
], ids=["lifted", "boundaries_above_the_max", "no_lift"])
def test_dev_full_length_caps_of_a_stream_equal_jax(synth, overrides):
    cfg, jcfg = _cfgs(synth / "smoke", *overrides)
    src, _ = cli._load_source(cfg, "dev")
    jsrc, _ = jax_cli._load_source(jcfg, "dev")
    assert src[0] == jsrc[0] == "stream"
    got = cli._lift_caps_for_split(cfg, src).data
    want = jax_cli._lift_caps_for_split(jcfg, jsrc).data
    for key in ("max_audio_seconds", "max_label_len", "bucket_boundaries"):
        assert getattr(got, key) == getattr(want, key), key
