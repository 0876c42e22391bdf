"""The port's unsupervised decode and entry points on the CPU: the
generator's decode view (``GeneratorInfer.logits_fn``) and
``run_inference``'s PER against the JAX package on converted weights, a
resumed GAN run against an unbroken one, the CLI's train-then-infer on
configs/synthetic_unsup_demo.yaml with label-free selection, and
``prepare kmeans`` against the JAX tool.

Sizes as tests/test_torch_unsup_train.py's. Bars: the decode chain after
the frontend 1e-5 and end to end 1e-4 (the frontend's bar), PER and
hypotheses equal; the resumed run bit-equal; k-means centroids 1e-4
(the frontend's bar on the features they are fitted to)."""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests._torch_unsup_cases import CASES, REPO, batches, cfgs, corpus
from uasr import train as jax_train
from uasr.data.dataset import Batch as JaxBatch
from uasr.infer import run_inference as jax_run_inference
from uasr.tools import prepare as jprepare
from uasr_torch import cli, infer, train
from uasr_torch.convert import flax_to_state_dict
from uasr_torch.data.dataset import batch_iterator, make_synthetic_dataset
from uasr_torch.data.io import write_wav
from uasr_torch.tools import prepare


@pytest.mark.parametrize("case", sorted(CASES))
def test_generator_decode_and_run_inference_match_jax(case, tmp_path):
    """GeneratorInfer.logits_fn on seeded flax weights (the merged stream
    in the bce case, the raw one in the WGAN case), and run_inference's
    PER and hypotheses."""
    examples, vocab = corpus(12, seed=2)
    jc, pc = cfgs(case, tmp_path, len(vocab))
    decode = list(batch_iterator(examples, 5, 16000, 8, shuffle=False, num_epochs=1,
                                 drop_remainder=False))
    jinf = jax_train.GeneratorInfer(jc)
    jinf.frontend_state  # built eagerly: a lazy build inside jit leaks a tracer
    g_params = jax.tree.map(np.asarray, jinf.init_params(jax.random.PRNGKey(3), decode[0][0],
                                                         decode[0][1]))
    ginf = train.GeneratorInfer(pc, device="cpu")
    ginf.gen.load_state_dict(flax_to_state_dict(g_params, pc))
    jgen = jax.jit(lambda p, f, n: jinf._gen_probs_full(p, JaxBatch(f, n, None, None)))
    for b in decode:
        audio, lens = jnp.asarray(b[0]), jnp.asarray(b[1])
        jl, jn = jax.jit(jinf.logits_fn)(g_params, audio, lens)
        with torch.no_grad():
            tl, tn = ginf.logits_fn(torch.tensor(b[0]), torch.tensor(b[1], dtype=torch.long))
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
        # end to end the frontend's own bar (its features differ from JAX's
        # within 1e-4); after it, the generator, merge and log at 1e-5
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-4)
        feats, flen = jax.jit(jinf._gen_feats)(JaxBatch(audio, lens, None, None))
        want = jgen(g_params, feats, flen)
        with torch.no_grad():
            got = ginf._probs_from_feats(None, torch.tensor(np.asarray(feats)),
                                         torch.tensor(np.asarray(flen), dtype=torch.long))
        for name, g, w in zip(("raw_probs", "raw_len", "probs", "len", "logits"), got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5,
                                       err_msg=name)
    jtr = jax_train.CTCTrainer(jc)
    jstate = jax_train.TrainState(0, g_params, jtr.optimizer.init(g_params))
    want = jax_run_inference(jc, jtr, jstate, iter(decode), vocab=vocab,
                             hyp_path=str(tmp_path / "j.txt"), logits_fn=jinf.logits_fn)
    got = infer.run_inference(pc, ginf.gen, ginf.frontend_state, iter(decode), vocab=vocab,
                              hyp_path=str(tmp_path / "t.txt"), device="cpu",
                              logits_fn=ginf.logits_fn)
    assert (got["per"], got["errors"], got["ref_tokens"]) == (
        want["per"], want["errors"], want["ref_tokens"])
    assert (tmp_path / "t.txt").read_text() == (tmp_path / "j.txt").read_text()


def test_eps_and_text_streams_resume_as_unbroken(tmp_path):
    """Two steps, a checkpoint, then one more equal three unbroken steps:
    ε is drawn from (seed, step, critic step) and the text order is
    fast-forwarded past the restored steps."""
    examples, vocab = corpus()
    _, pc = cfgs("bce_eodm", tmp_path, len(vocab))
    text = [ids for _, ids in examples]
    per = pc.gan.disc_steps + 1
    audio = batches(examples, 3 * per)
    states = {}
    for name, cuts in (("unbroken", [(0, 3)]), ("resumed", [(0, 2), (2, 3)])):
        cfg = dataclasses.replace(pc, model_dir=str(tmp_path / name))
        for a, b in cuts:
            cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, total_steps=b))
            _, st = train.run_gan_training(cfg, iter(audio[a * per:b * per]), text,
                                           with_eodm=True, device="cpu")
        states[name] = st
    assert states["resumed"].step == states["unbroken"].step == 3
    for tree in ("g_params", "d_params"):
        for k, v in getattr(states["unbroken"], tree).items():
            torch.testing.assert_close(getattr(states["resumed"], tree)[k], v, rtol=0, atol=0)


# --------------------------------------------------------------------- CLI


RECIPE = str(REPO / "configs" / "synthetic_unsup_demo.yaml")


@pytest.mark.parametrize("mode", ["gan+eodm", "eodm"])
def test_cli_trains_then_infers_the_unsupervised_demo(mode, tmp_path, capsys):
    """A few steps with label-free selection (an LM from `prepare lm` on
    the corpus' transcripts), resume, decode the newest and the selected
    checkpoint."""
    examples, vocab = make_synthetic_dataset(num_utts=40, num_phones=6, seed=0,
                                             syntax="markov", min_len=4, max_len=10)
    (tmp_path / "text.txt").write_text("\n".join(" ".join(vocab.decode(ids))
                                                 for _, ids in examples) + "\n")
    (tmp_path / "vocab.txt").write_text("\n".join(vocab.tokens) + "\n")
    prepare.main(["lm", "--text", str(tmp_path / "text.txt"), "--vocab",
                  str(tmp_path / "vocab.txt"), "--out", str(tmp_path / "lm.npz")])
    args = ["-c", RECIPE, "--device", "cpu", "--set", f"model_dir={tmp_path}",
            "--set", f"train.mode={mode}", "--set", "data.synthetic_num_utts=40",
            "--set", "data.batch_size=8", "--set", "train.log_every=2",
            "--set", "data.synthetic_dev_utts=8", "--set", "train.eval_every=4",
            "--set", "train.total_steps=4",
            "--set", f"gan.select_lm_path={tmp_path / 'lm.npz'}"]
    assert cli.main(args) == 0
    out = capsys.readouterr().out
    assert "[train] step 4:" in out and "[dev] step 4: per=" in out
    assert "unsup_score=" in out and "unsup_best=" in out
    assert json.loads((tmp_path / "best_ckpt" / "score.json").read_text())["step"] == 4
    recs = [json.loads(ln) for ln in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    key = "g_loss" if mode == "gan+eodm" else "eodm_loss"
    assert [r["step"] for r in recs if r["tag"] == "train"] == [2, 4]
    assert all(np.isfinite(r[key]) for r in recs if r["tag"] == "train")
    assert cli.main(args + ["--set", "train.total_steps=6"]) == 0
    assert "[resume] step 4: restored_step=4" in capsys.readouterr().out
    assert cli.main(args + ["--mode", "infer"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("step 6: PER=")
    assert len((tmp_path / "hyp.txt").read_text().splitlines()) == 8
    assert cli.main(args + ["--mode", "infer", "--set", "train.restore_best=true"]) == 0
    assert capsys.readouterr().out.startswith("step 4: PER=")


def test_prepare_kmeans_equals_jax_tool(tmp_path):
    examples, vocab = corpus(6)
    lines = []
    for i, (audio, ids) in enumerate(examples):
        write_wav(str(tmp_path / f"u{i}.wav"), audio, 16000)
        lines.append(f"u{i}\t{tmp_path / f'u{i}.wav'}\t{' '.join(vocab.decode(ids))}")
    (tmp_path / "list.tsv").write_text("\n".join(lines) + "\n")
    (tmp_path / "vocab.txt").write_text("\n".join(vocab.tokens) + "\n")
    recipe = tmp_path / "r.yaml"
    recipe.write_text("frontend:\n  num_mel_bins: 16\n  cmvn: utterance\n"
                      "gan:\n  kmeans_clusters: 5\n  segment_on_raw: true\n")
    common = ["kmeans", "--config", str(recipe), "--list", str(tmp_path / "list.tsv"),
              "--vocab", str(tmp_path / "vocab.txt"), "--iters", "4"]
    prepare.main(common + ["--out", str(tmp_path / "t.npz"), "--device", "cpu"])
    jprepare.main(common + ["--out", str(tmp_path / "j.npz")])
    got, want = np.load(tmp_path / "t.npz")["centroids"], np.load(tmp_path / "j.npz")["centroids"]
    assert got.shape == (5, 16)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
