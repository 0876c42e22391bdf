"""The port's one-command unsupervised pipeline (uasr_torch.tools.pipeline):
the JAX package's fast tests of ``uasr.tools.pipeline`` (tests/test_pipeline.py)
on the port — the manifest's --force-from and digest refusal,
``_null_nonfinite``, the stale-student wipe, the newest checkpoint step, a
supervised recipe's rejection — and one end-to-end run on the CPU at the
smallest widths: ssl -> featurize -> lm -> a two-seed sweep -> one
self-training round, its report and export recipes, the skip of every
stage on rerun, ``--force-from selftrain``, and the composed audio -> text
export of the winner (``--compose-from-pipeline``, ``--check``: the
reloaded program bit-equal to the live forward).

Each stage is held to the JAX package in its own tests; this run checks
what the pipeline adds."""

import json
import os

import pytest
import torch

from uasr_torch.tools import pipeline as P

SSL_YAML = """
name: pipe_ssl
vocab_size: 8
model: {dtype: float32}
ssl:
  conv_channels: [8, 8, 16]
  conv_kernels: [64, 10, 8]
  conv_strides: [16, 10, 3]
  context_hidden: 16
  predict_steps: 2
  num_negatives: 0
  feature_layer: latents
data:
  synthetic: true
  synthetic_num_utts: 32
  synthetic_dev_utts: 16
  synthetic_syntax: markov
  synthetic_min_len: 4
  synthetic_max_len: 8
  batch_size: 16
  max_audio_seconds: 1.5
  max_label_len: 10
train:
  mode: ssl
  total_steps: 3
  lr: 2.0e-3
  warmup_steps: 1
  eval_every: 10000
  save_every: 3
  log_every: 50
"""

GAN_YAML = """
name: pipe_gan
vocab_size: 8
model:
  encoder: classifier
  classifier_hidden: 16
  classifier_layers: 1
  classifier_context: 1
  disc_channels: 8
  disc_layers: 1
gan:
  objective: bce
  disc_steps: 1
  merge_repeats: true
data:
  max_frames: 20
  batch_size: 16
  max_label_len: 10
train:
  mode: gan+eodm
  total_steps: 3
  lr: 3.0e-4
  eval_every: 3
  save_every: 3
  log_every: 15
  dev_eval_batches: 1
eodm:
  ngram_orders: [1, 2]
  top_k: 8
  weight: 1.0
"""


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite runs files in parallel workers, and
    an oversubscribed pool slows the many small ops here several times."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def test_manifest_force_from_clears_suffix(tmp_path):
    m = P._Manifest(str(tmp_path), None)
    m.record("ssl", {})
    m.record("lm", {})
    m.record("sweep", {})
    m2 = P._Manifest(str(tmp_path), "lm")
    assert m2.done("ssl") is not None
    assert m2.done("lm") is None and m2.done("sweep") is None


def test_manifest_digest_mismatch_refuses(tmp_path):
    """A completed stage recorded under other arguments refuses the silent
    skip; the same digest, a record without one, and --force-from pass."""
    m = P._Manifest(str(tmp_path), None)
    m.record("sweep", {}, digest="aaaa")
    m2 = P._Manifest(str(tmp_path), None)
    with pytest.raises(SystemExit, match="force-from sweep"):
        m2.check({"sweep": "bbbb"})
    m2.check({"sweep": "aaaa"})
    m2.check({"ssl": "anything"})
    P._Manifest(str(tmp_path), "sweep").check({"sweep": "bbbb"})


def test_null_nonfinite_pers():
    rec = {"teacher_per": float("nan"), "student_per": 0.3, "x": 1}
    out = P._null_nonfinite(rec, ("teacher_per", "student_per"))
    assert out["teacher_per"] is None and out["student_per"] == 0.3
    assert json.loads(json.dumps(out))["teacher_per"] is None


def test_stale_student_wipe(tmp_path):
    """Changed labelling settings wipe the existing selftrain_r* students;
    identical settings keep them."""
    from uasr_torch.config import Config
    from uasr_torch.tools.selftrain import _invalidate_stale_students

    cfg = Config(model_dir=str(tmp_path / "student"))
    r0 = tmp_path / "student" / "selftrain_r0" / "ckpt"
    r0.mkdir(parents=True)
    (r0 / "20.pt").write_bytes(b"")
    _invalidate_stale_students(cfg, "/t/ckpt", 600, "gan", 0.0, False, None)
    assert r0.exists()  # the first write of the meta never wipes
    _invalidate_stale_students(cfg, "/t/ckpt", 600, "gan", 0.0, False, None)
    assert r0.exists()
    _invalidate_stale_students(cfg, "/t/ckpt", 600, "gan", 0.5, False, None)
    assert not r0.exists()


def test_existing_ckpt_step(tmp_path):
    from uasr_torch.selftrain import _existing_ckpt_step

    assert _existing_ckpt_step(str(tmp_path / "none")) is None
    assert not (tmp_path / "none").exists()  # creates nothing
    d = tmp_path / "ckpt"
    d.mkdir()
    assert _existing_ckpt_step(str(d)) is None
    for name in ("40.pt", "120.pt", "160.pt.77.tmp"):  # an unfinished save is ignored
        (d / name).write_bytes(b"")
    assert _existing_ckpt_step(str(d)) == 120


def test_pipeline_rejects_supervised_recipe(tmp_path):
    yml = tmp_path / "ctc.yaml"
    yml.write_text("name: x\ntrain: {mode: ctc}\n")
    with pytest.raises(SystemExit, match="gan"):
        P.main(["--workdir", str(tmp_path / "wd"), "--unsup-config", str(yml),
                "--device", "cpu"])


def test_pipeline_end_to_end_skip_force_and_export(tmp_path, capsys):
    from uasr_torch.tools import export

    (tmp_path / "ssl.yaml").write_text(SSL_YAML)
    (tmp_path / "gan.yaml").write_text(GAN_YAML)
    wd = str(tmp_path / "pipe")
    args = ["--workdir", wd, "--ssl-config", str(tmp_path / "ssl.yaml"),
            "--unsup-config", str(tmp_path / "gan.yaml"), "--seeds", "2", "--cmvn",
            "--selftrain-rounds", "1", "--student-steps", "2", "--device", "cpu"]
    assert P.main(args) == 0
    out, err = capsys.readouterr()
    assert os.path.exists(f"{wd}/lm.npz")
    with open(f"{wd}/unsup/sweep.json") as f:
        sweep = json.load(f)
    assert len(sweep["ranking"]) == 2
    assert sweep["winner"]["score"] == max(x["score"] for x in sweep["ranking"])
    with open(f"{wd}/report.json") as f:
        report = json.load(f)
    assert set(report["stages"]) == set(P.STAGES)
    assert 0.0 <= report["teacher_per"] < 5.0 and 0.0 <= report["student_per"] < 5.0
    assert os.path.isdir(os.path.join(report["student_dir"], "ckpt"))
    # never ship a student worse than its teacher
    if report["student_per"] <= report["teacher_per"]:
        assert report["final_model"] == report["student_dir"]
    else:
        assert report["final_model"] == report["winner"]["model_dir"]
        assert "did not help" in err
    assert "lifting data.max_frames" in err  # the GAN window lifted for labelling
    last = json.loads(out.strip().splitlines()[-1])
    assert last["winner"]["model_dir"] == sweep["winner"]["model_dir"]
    assert last["final_model"] == report["final_model"]

    # a rerun skips every stage and reports the same
    assert P.main(args) == 0
    _, err = capsys.readouterr()
    for stage in P.STAGES:
        assert f"stage {stage}: done (skip)" in err, stage
    with open(f"{wd}/report.json") as f:
        assert json.load(f)["student_per"] == report["student_per"]

    # --force-from runs the stage and everything after it again
    assert P.main(args + ["--force-from", "selftrain"]) == 0
    _, err = capsys.readouterr()
    assert "stage sweep: done (skip)" in err and "stage selftrain: running" in err

    # the cache-trained winner as an audio -> text program (the student's
    # recipe is written beside it)
    assert os.path.exists(f"{wd}/export_student.yaml")
    assert export.main(["-c", f"{wd}/export_winner.yaml", "--out", f"{wd}/serve",
                        "--compose-from-pipeline", wd, "--check", "--device", "cpu",
                        "--batch", "2", "--seconds", "1.5"]) == 0
    with open(f"{wd}/serve/meta.json") as f:
        meta = json.load(f)
    assert meta["composed_featurizer"]["cmvn"] is True and meta["audio_shape"] == [2, 24000]
    assert "check ok" in capsys.readouterr().err
