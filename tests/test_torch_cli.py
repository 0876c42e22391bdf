"""The port's CLI on the CPU: train a few steps of configs/synthetic_smoke.yaml
with a conv_bigru encoder (the recipe's cnn encoder belongs to a later
slice), resume, decode; the default device needs a card; --set casts and
rejects unknown keys as uasr.cli does; train.mode ssl pretrains."""

import json
import pathlib

import pytest
import torch

from uasr_torch import cli

RECIPE = str(pathlib.Path(__file__).resolve().parents[1] / "configs" / "synthetic_smoke.yaml")
SMALL = ["--set", "model.encoder=conv_bigru", "--set", "model.hidden_size=16",
         "--set", "model.num_gru_layers=2", "--set", "model.conv_channels=4",
         "--set", "data.synthetic_num_utts=24", "--set", "train.log_every=2",
         "--set", "train.save_every=2"]


def test_train_resume_infer(tmp_path, capsys):
    args = ["-c", RECIPE, "--device", "cpu", "--set", f"model_dir={tmp_path}", *SMALL]
    assert cli.main(args + ["--set", "train.total_steps=4"]) == 0
    out = capsys.readouterr().out
    assert "[train] step 4:" in out
    recs = [json.loads(ln) for ln in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs] == [2, 4]
    assert all(r["loss"] > 0 and r["grad_norm"] > 0 for r in recs)

    assert cli.main(args + ["--set", "train.total_steps=6"]) == 0
    out = capsys.readouterr().out
    assert "[resume] step 4: restored_step=4" in out and "[train] step 6:" in out

    assert cli.main(args + ["--mode", "infer", "--set", "data.synthetic_dev_utts=8"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("step 6: PER=")
    assert len((tmp_path / "hyp.txt").read_text().splitlines()) == 8


def test_default_device_needs_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device does not raise")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["-c", RECIPE, "--set", f"model_dir={tmp_path}", *SMALL])


@pytest.mark.parametrize("override,match", [
    ("train.total_steps=abc", "cannot parse"),
    ("train.no_such_key=1", "no such config field"),
    ("total_steps", "key=value"),
])
def test_bad_overrides_exit(override, match, tmp_path):
    with pytest.raises(SystemExit, match=match):
        cli.main(["-c", RECIPE, "--device", "cpu", "--set", override])


@pytest.mark.parametrize("mode,match", [("ssl", "nce_acc=")])
def test_unported_modes_raise(mode, match, tmp_path, capsys):
    """The modes that once raised here are ported: ``ssl`` pretrains the
    recipe's synthetic audio (a narrowed CPC model) and logs ``match``."""
    assert cli.main(["-c", RECIPE, "--device", "cpu", "--set", f"train.mode={mode}",
                     "--set", f"model_dir={tmp_path}", "--set", "train.total_steps=2",
                     "--set", "train.log_every=1", "--set", "data.synthetic_num_utts=16",
                     "--set", "ssl.conv_channels=16,16,32", "--set", "ssl.conv_kernels=8,4,4",
                     "--set", "ssl.conv_strides=8,5,4", "--set", "ssl.context_hidden=16",
                     "--set", "ssl.num_negatives=4", "--set", "ssl.predict_steps=3"]) == 0
    assert match in capsys.readouterr().out
    assert (tmp_path / "ckpt" / "2.pt").exists()
