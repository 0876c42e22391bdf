"""Data parallelism of the port on the CPU: one 2-rank gloo group (mesh
(data, model) = (2, 1); tests/_torch_dist_worker.py ranks, which import no
jax) against the JAX package's steps on the same global batch, JAX on its
own 8-device CPU mesh (GSPMD: the global-batch step); and the multichip
dry run's six steps in the 4-rank group of tests/test_torch_parallel_tp.py.

Cases, one spawn for all: the CTC step (conv_bigru), the frame-CE step,
GAN critic, critic and generator steps with the entropy, diversity and
smoothness penalties, an EODM step, an SSL step and the SSL dev eval of
a ragged batch (B = 5), two ``grad_accum: 2``
calls over a batch's halves (against JAX's step on the whole batch, which
JAX's own test holds equal to its MultiSteps), the beam decode of ragged
batches (B = 5; hypotheses bit-equal) and a checkpoint written on the
mesh and restored in one process (bit-equal). Bars in
tests/_torch_parallel_cases.py. The frame-CE case is the classifier's
(frontend downsample 3), whose JAX step compiles in a fraction of the
BiGRU's; the CTC case runs the BiGRU.
"""

import pathlib

import numpy as np
import pytest
import torch

from tests._torch_parallel_cases import (
    check_aux, check_gan, check_params, ctc_batches, ctc_case, decode_case, jax_ctc,
    sd, same_on_every_rank, ssl_case, start, unsup_cases,
)
from uasr_torch.convert import flax_to_state_dict
from uasr_torch.data import dataset as pds


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Every case's spec from JAX's initial state, the group started on
    them, JAX's steps run meanwhile; the group's results and JAX's."""
    tmp = tmp_path_factory.mktemp("two_ranks")
    cases, refs = [], {}
    batches, vocab = ctc_batches(1)
    pc, jc = ctc_case(len(vocab))
    init, ctc_ref = jax_ctc(jc, batches)
    weights = sd(flax_to_state_dict(init, pc))
    cases.append(("ctc", dict(kind="ctc", cfg=pc, weights=weights, batches=batches,
                              ckpt_dir=str(tmp / "ckpt"))))
    halves = [tuple(x[:2] for x in batches[0]), tuple(x[2:] for x in batches[0])]
    accum, _ = ctc_case(len(vocab), grad_accum=2)
    cases.append(("accum", dict(kind="ctc", cfg=accum, weights=weights, batches=halves)))
    ex, fvocab = pds.make_synthetic_dataset(num_utts=4, num_phones=6, seed=3,
                                            with_alignments=True)
    aligned = [tuple(np.asarray(x) for x in next(iter(
        pds.aligned_batch_iterator(ex, 4, 16000, 8, 98, seed=1))))]
    fpc, fjc = ctc_case(len(fvocab), mode="frame_ce", downsample=3,
                        model=dict(encoder="classifier", classifier_hidden=16,
                                   classifier_layers=2, classifier_context=1))
    finit, fce_ref = jax_ctc(fjc, aligned)
    cases.append(("frame_ce", dict(kind="ctc", cfg=fpc, batches=aligned,
                                   weights=sd(flax_to_state_dict(finit, fpc)))))
    gan_spec, eodm_spec, unsup_refs = unsup_cases(tmp)
    ssl_spec, ssl_ref = ssl_case(tmp)
    dec_spec, dec_ref = decode_case(tmp)
    cases += [("gan", gan_spec), ("eodm", eodm_spec), ("ssl", ssl_spec), ("decode", dec_spec)]
    join = start(cases, 2, tmp)

    aux, final = ctc_ref()
    refs["ctc"] = (aux, sd(flax_to_state_dict(final, pc)), pc)
    aux, final = fce_ref()
    refs["frame_ce"] = (aux, sd(flax_to_state_dict(final, fpc)))
    refs["gan"], refs["eodm"] = unsup_refs()
    refs["ssl"] = ssl_ref()
    refs["decode"] = dec_ref()
    return dict(results=join(), refs=refs, tmp=tmp)


def test_dp_ctc_step_matches_jax(two_ranks):
    res = same_on_every_rank(two_ranks["results"], "ctc")
    aux, want, _ = two_ranks["refs"]["ctc"]
    check_aux(res["aux"][0], aux[0], "ctc")
    np.testing.assert_allclose(res["clip_norms"], [aux[0]["grad_norm"]], rtol=1e-4)
    check_params(res["params"], want, what="ctc")


def test_dp_frame_ce_step_matches_jax(two_ranks):
    res = same_on_every_rank(two_ranks["results"], "frame_ce")
    aux, want = two_ranks["refs"]["frame_ce"]
    assert 0 < res["aux"][0]["frame_acc"] <= 1
    check_aux(res["aux"][0], aux[0], "frame_ce")
    check_params(res["params"], want, what="frame_ce")


def test_dp_gan_critic_and_generator_steps_match_jax(two_ranks):
    res = same_on_every_rank(two_ranks["results"], "gan")
    check_gan(res, two_ranks["refs"]["gan"], "gan")


def test_dp_eodm_step_matches_jax(two_ranks):
    res = same_on_every_rank(two_ranks["results"], "eodm")
    aux, want = two_ranks["refs"]["eodm"]
    check_aux(res["aux"][0], aux[0], "eodm")
    check_params(res["params"], want, what="eodm")


def test_dp_ssl_step_matches_jax(two_ranks):
    res = same_on_every_rank(two_ranks["results"], "ssl")
    aux, want, _ = two_ranks["refs"]["ssl"]
    check_aux(res["aux"][0], aux[0], "ssl")
    check_params(res["params"], want, what="ssl")


def test_dp_ssl_dev_eval_of_a_ragged_batch_matches_jax(two_ranks):
    """A dev batch of 5 rows splits over 2 data ranks zero-padded; each
    rank reports the whole batch's InfoNCE loss and accuracy."""
    want = two_ranks["refs"]["ssl"][2]
    for r in two_ranks["results"]:
        loss, acc = r["ssl"]["dev"]
        check_aux({"nce_loss": loss, "nce_acc": acc}, want, "ssl dev eval")


def test_dp_grad_accum_matches_jax_global_batch_step(two_ranks):
    """Two ``grad_accum: 2`` calls over the halves of the CTC case's batch
    update once, to JAX's step on the whole batch; each call's loss is
    its half's."""
    res = same_on_every_rank(two_ranks["results"], "accum")
    aux, want, _ = two_ranks["refs"]["ctc"]
    assert res["step"] == 2
    losses = [a["loss"] for a in res["aux"]]
    np.testing.assert_allclose(np.mean(losses), aux[0]["loss"], rtol=1e-4)
    # the clip sees the accumulated mean: its norm before the clip is the
    # whole batch's gradient norm (a sum, or any other scale, is not)
    assert len(res["clip_norms"]) == 1
    np.testing.assert_allclose(res["clip_norms"][0], aux[0]["grad_norm"], rtol=1e-4)
    check_params(res["params"], want, what="accum")


def test_multi_rank_decode_of_a_ragged_batch_matches_jax(two_ranks):
    ref = two_ranks["refs"]["decode"]
    for r in two_ranks["results"]:
        assert r["decode"]["impl"] == "reference_sharded"
        assert r["decode"]["res"]["errors"] == ref["res"]["errors"]
        assert r["decode"]["res"]["ref_tokens"] == ref["res"]["ref_tokens"]
    hyp = pathlib.Path(two_ranks["tmp"] / "hyp_port.txt").read_text()
    assert hyp == pathlib.Path(ref["hyp"]).read_text() and hyp.count("\n") == 10


def test_mesh_checkpoint_restores_bit_equal_in_one_process(two_ranks):
    from uasr_torch import train
    from uasr_torch.checkpoint import CheckpointManager

    res = two_ranks["results"][0]["ctc"]
    pc = two_ranks["refs"]["ctc"][2]
    trainer = train.CTCTrainer(pc, device="cpu")
    restored, step = CheckpointManager(str(two_ranks["tmp"] / "ckpt")).restore_latest(
        trainer.init_state())
    assert step == 1 and restored.step == 1
    for k, v in res["params"].items():
        np.testing.assert_array_equal(restored.params[k].detach().numpy(), v, err_msg=k)


@pytest.mark.parametrize("device, backend, ranks, cards, shared", [
    ("cuda", None, 4, 4, False),   # NCCL, rank r on cuda:r
    ("cuda", "nccl", 2, 8, False),
    ("cuda", "gloo", 4, 4, False),  # enough cards: spread over gloo too
    ("cuda", "gloo", 4, 1, True),   # the one-card rehearsal
    ("cuda", "gloo", 4, 2, True),
    ("cpu", None, 4, 0, False),
    ("cpu", "gloo", 4, 1, False),
])
def test_dryrun_places_ranks_on_cards(device, backend, ranks, cards, shared):
    from uasr_torch.tools.dryrun_multichip import one_card

    assert one_card(device, backend, ranks, cards) is shared


@pytest.mark.parametrize("backend", [None, "nccl"])
def test_dryrun_refuses_nccl_with_fewer_cards_than_ranks(backend):
    from uasr_torch.tools.dryrun_multichip import one_card

    with pytest.raises(SystemExit, match="--backend gloo"):
        one_card("cuda", backend, 4, 1)
