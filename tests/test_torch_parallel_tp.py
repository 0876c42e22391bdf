"""Tensor and sequence parallelism of the port on the CPU: one 4-rank
gloo group (mesh (data, model) = (2, 2); tests/_torch_dist_worker.py
ranks) against the JAX package's steps on the same global batch (JAX on
its own 8-device CPU mesh), and ``param_shardings`` against JAX's rule.

Cases, one spawn for all: the transformer and the conformer (d = 32, 4
heads, 2 blocks; the conformer's relative-position tables drawn off zero)
with their heads and FFN columns split Megatron-style, with and without
``sequence_shard`` (the residual stream split over time between
sublayers), one CTC step each and their forward (JAX's
tests/test_parallel.py cases); the classifier generator and the critic
on ``model_parallel: 2`` (GAN critic, critic, generator steps and an EODM
step); a checkpoint of the sharded transformer, which holds whole
tensors; and the multichip dry run's six steps (``tools.dryrun_multichip
.run_steps``; its launcher runs on the card in chip_smoke.py). Bars in
tests/_torch_parallel_cases.py; logits atol 1e-4.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from tests._torch_parallel_cases import (
    ATOL, ATTN_MODEL, CTC_MODEL, check_aux, check_gan, check_params, ctc_batches, ctc_case,
    jax_ctc, sd, same_on_every_rank, start, to_np, unsup_cases,
)
from uasr import train as jax_train
from uasr_torch import config as tc
from uasr_torch.convert import flax_to_state_dict


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("four_ranks")
    cases, pending, refs = [], {}, {}
    batches, vocab = ctc_batches(1, B=8, seed=4)
    for enc in ("transformer", "conformer"):
        pc, jc = ctc_case(len(vocab), model=dict(ATTN_MODEL, encoder=enc), m=2)
        init, run = jax_ctc(jc, batches, rel_seed=3 if enc == "conformer" else None)
        weights = sd(flax_to_state_dict(init, pc))
        for seq in (False, True):
            cfg = dataclasses.replace(pc, model=dataclasses.replace(pc.model,
                                                                    sequence_shard=seq))
            cases.append((f"{enc}_{seq}", dict(kind="ctc", cfg=cfg, weights=weights,
                                               batches=batches,
                                               ckpt_dir=str(tmp / f"ckpt_{enc}") if seq
                                               else None)))
        cases.append((f"{enc}_forward", dict(kind="forward", cfg=cfg, weights=weights,
                                             batch=batches[0])))
        pending[enc] = (jc, init, run, pc)
    gan_spec, eodm_spec, unsup_refs = unsup_cases(tmp, m=2)
    cases += [("gan", gan_spec), ("eodm", eodm_spec),
              ("dryrun", dict(kind="dryrun", model_parallel=2))]
    join = start(cases, 4, tmp)
    for enc, (jc, init, run, pc) in pending.items():
        jtr = jax_train.CTCTrainer(jc)
        feats, flen = jtr._feats(batches[0][0], batches[0][1])
        logits, _ = jax.jit(jtr.model.apply)(jax.tree.map(jax.numpy.asarray, init), feats, flen)
        aux, final = run()
        refs[enc] = (aux, sd(flax_to_state_dict(final, pc)), np.asarray(logits), pc)
    refs["gan"], refs["eodm"] = unsup_refs()
    return dict(results=join(), refs=refs, tmp=tmp)


@pytest.mark.parametrize("encoder", ["transformer", "conformer"])
@pytest.mark.parametrize("seq", [False, True], ids=["heads", "sequence_shard"])
def test_tp_attention_step_matches_jax(four_ranks, encoder, seq):
    """Every rank of the (2, 2) mesh holds JAX's global-batch step."""
    name = f"{encoder}_{seq}"
    res = same_on_every_rank(four_ranks["results"], name)
    aux, want, _, pc = four_ranks["refs"][encoder]
    assert any(k.startswith("mha0.query") for k in res["sharded"]), res["sharded"]
    check_aux(res["aux"][0], aux[0], name)
    check_params(res["params"], want, lr=pc.train.lr, what=name)


@pytest.mark.parametrize("encoder", ["transformer", "conformer"])
def test_tp_attention_forward_matches_jax(four_ranks, encoder):
    want = four_ranks["refs"][encoder][2]
    for r in four_ranks["results"]:
        np.testing.assert_allclose(r[f"{encoder}_forward"]["logits"], want, rtol=0,
                                   atol=ATOL, err_msg=encoder)


def test_sharded_checkpoint_holds_whole_tensors(four_ranks):
    """A transformer trained with its leaves sharded over the model group
    checkpoints whole tensors, which restore in one process bit-equal."""
    from uasr_torch import train
    from uasr_torch.checkpoint import CheckpointManager

    pc = four_ranks["refs"]["transformer"][3]
    pc = dataclasses.replace(pc, parallel=tc.ParallelConfig(model_parallel=1))
    trainer = train.CTCTrainer(pc, device="cpu")
    restored, _ = CheckpointManager(str(four_ranks["tmp"] / "ckpt_transformer")).restore_latest(
        trainer.init_state())
    res = four_ranks["results"][0]["transformer_True"]
    for k, v in res["params"].items():
        np.testing.assert_array_equal(restored.params[k].detach().numpy(), v, err_msg=k)


def test_tp_classifier_gan_and_eodm_steps_match_jax(four_ranks):
    """The classifier generator and the critic on ``model_parallel: 2``:
    column-parallel products gathered over the model group, the gradient
    penalty's double backward through the collectives."""
    res = same_on_every_rank(four_ranks["results"], "gan")
    check_gan(res, four_ranks["refs"]["gan"], "tp gan")
    res = same_on_every_rank(four_ranks["results"], "eodm")
    aux, want = four_ranks["refs"]["eodm"]
    check_aux(res["aux"][0], aux[0], "tp eodm")
    check_params(res["params"], want, what="tp eodm")


def test_dryrun_multichip_six_steps_on_the_2x2_mesh(four_ranks):
    """``tools.dryrun_multichip``'s steps (CTC, GAN critic and generator,
    EODM, the transformer with sequence_shard, SSL) give finite losses on
    every rank, the same on every rank."""
    keys = ("ctc_loss", "d_loss", "g_loss", "eodm_loss", "transformer_ctc_loss", "nce_loss")
    first = four_ranks["results"][0]["dryrun"]
    assert first["mesh"] == {"data": 2, "model": 2}
    for r in four_ranks["results"]:
        assert all(np.isfinite(r["dryrun"][k]) for k in keys)
        assert [r["dryrun"][k] for k in keys] == [first[k] for k in keys]


@pytest.mark.parametrize("encoder", ["conv_bigru", "transformer", "conformer", "classifier"])
def test_param_shardings_pick_the_leaves_jax_shards(encoder):
    """``param_shardings`` marks exactly the leaves JAX's rule shards on a
    model axis of 2: JAX's marks carried through ``flax_to_state_dict`` as
    all-ones tensors."""
    from uasr.parallel.mesh import make_mesh as jax_make_mesh
    from uasr.parallel.mesh import param_shardings as jax_param_shardings
    from uasr_torch.models.models import build_model
    from uasr_torch.parallel import param_shardings

    batches, vocab = ctc_batches(1)
    model = {"conv_bigru": dict(CTC_MODEL, hidden_size=16),
             "classifier": dict(encoder="classifier", classifier_hidden=24,
                                classifier_layers=2)}.get(encoder, dict(ATTN_MODEL,
                                                                        encoder=encoder))
    pc, jc = ctc_case(len(vocab), model=model)
    jtr = jax_train.CTCTrainer(jc)
    feats, flen = jtr._feats(batches[0][0], batches[0][1])
    params = jax.eval_shape(jtr.model.init, jax.random.PRNGKey(0), feats, flen)
    specs = jax_param_shardings(params, jax_make_mesh(2))
    marks = jax.tree.map(lambda p, s: np.full(p.shape, 1.0 if "model" in str(s.spec) else 0.0,
                                              np.float32), params, specs)
    want = {k for k, v in flax_to_state_dict(to_np(marks), pc).items() if bool((v == 1).all())}
    got = param_shardings(build_model(pc.model, pc.dim_output, 16, device="cpu"), 2)
    assert want and {k for k, d in got.items() if d is not None} == want
