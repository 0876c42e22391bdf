"""The decode slice end to end: the JAX package's run_inference on a small
conv+BiGRU CTCTrainer state (beam through the Pallas kernel in interpret
mode, and greedy) against the port's run_inference on the converted
parameters, on the CPU."""

import dataclasses
import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from uasr.config import Config as JaxConfig
from uasr.config import CTCConfig as JaxCTCConfig
from uasr.config import FrontendConfig as JaxFrontendConfig
from uasr.config import ModelConfig as JaxModelConfig
from uasr.config import TrainConfig as JaxTrainConfig
from uasr.data.dataset import batch_iterator, make_synthetic_dataset
from uasr.infer import run_inference as jax_run_inference
from uasr.train import CTCTrainer, TrainState
from uasr.vocab import load_vocab as jax_load_vocab
from uasr.vocab import make_vocab as jax_make_vocab
from uasr_torch import config as tc
from uasr_torch import infer
from uasr_torch.convert import flax_to_state_dict
from uasr_torch.frontend.features import make_frontend_state
from uasr_torch.models.models import build_model
from uasr_torch.vocab import Vocab, load_vocab, make_vocab

FRONTEND = dict(num_mel_bins=24)
MODEL = dict(encoder="conv_bigru", hidden_size=16, num_gru_layers=2, conv_channels=4)


@pytest.fixture(scope="module")
def trained():
    examples, vocab = make_synthetic_dataset(num_utts=16, num_phones=6, seed=6)
    cfg = JaxConfig(frontend=JaxFrontendConfig(**FRONTEND), model=JaxModelConfig(**MODEL),
                    train=JaxTrainConfig(total_steps=1), vocab_size=len(vocab))
    trainer = CTCTrainer(cfg)
    first = next(iter(batch_iterator(examples, 8, 16000, 8, shuffle=False)))
    # init_state's parameters, with the model's init jitted (seconds faster)
    feats, flen = trainer._feats(first.audio, first.audio_lengths)
    params = jax.jit(trainer.model.init)(jax.random.PRNGKey(0), feats, flen)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       opt_state=trainer.optimizer.init(params))
    return examples, vocab, cfg, trainer, state


def _batches(examples):
    return itertools.islice(batch_iterator(examples, 8, 16000, 8, shuffle=False), 2)


def _port(cfg_kw, vocab_len, params):
    cfg = tc.Config(frontend=tc.FrontendConfig(**FRONTEND),
                    model=tc.ModelConfig(gru_pallas=True, **MODEL),
                    ctc=tc.CTCConfig(**cfg_kw), vocab_size=vocab_len)
    model = build_model(cfg.model, vocab_len, cfg.frontend.dim_input, device="cpu")
    model.load_state_dict(flax_to_state_dict(jax.tree.map(np.asarray, params), cfg))
    return cfg, model, make_frontend_state(cfg.frontend, device="cpu")


@pytest.mark.parametrize("use_beam", [True, False], ids=["beam", "greedy"])
def test_run_inference_matches_jax(trained, use_beam, tmp_path, monkeypatch):
    monkeypatch.setenv("UASR_PALLAS_BEAM", "interpret")
    examples, vocab, jcfg, trainer, state = trained
    ctc_kw = dict(use_beam=use_beam, beam_width=4)
    jcfg = dataclasses.replace(jcfg, ctc=JaxCTCConfig(**ctc_kw))
    j_hyp, t_hyp = tmp_path / "jax_hyp.txt", tmp_path / "torch_hyp.txt"
    ref = jax_run_inference(jcfg, trainer, state, _batches(examples), vocab=vocab,
                            hyp_path=str(j_hyp))
    cfg, model, fstate = _port(ctc_kw, len(vocab), state.params)
    got = infer.run_inference(cfg, model, fstate, _batches(examples),
                              vocab=Vocab(tokens=vocab.tokens, blank_id=vocab.blank_id),
                              hyp_path=str(t_hyp), device="cpu")
    for key in ("errors", "ref_tokens", "audio_seconds", "per"):
        assert got[key] == ref[key], key
    assert got["rtf"] > 0
    assert t_hyp.read_text() == j_hyp.read_text()
    assert infer.LAST_BEAM_IMPL == ("reference" if use_beam else None)


def test_entry_points_need_cuda_or_explicit_cpu(trained, tmp_path):
    examples, vocab, _, _, state = trained
    cfg, model, fstate = _port({}, len(vocab), state.params)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            infer.run_inference(cfg, model, fstate, _batches(examples))
        with pytest.raises(RuntimeError, match="cuda"):
            make_frontend_state(cfg.frontend)
    V = len(vocab)
    wrong_lm = str(tmp_path / "lm.npz")  # a bigram table of V - 1 symbols
    np.savez(wrong_lm, logp=np.zeros((V, V - 1), np.float32))
    refused = [
        (dataclasses.replace(cfg, ctc=tc.CTCConfig(use_viterbi=True)), {}, ValueError,
         "use_viterbi needs ctc.lm_path"),
        (dataclasses.replace(cfg, ctc=tc.CTCConfig(use_viterbi=True, lm_path=wrong_lm)), {},
         ValueError, "trigram table, got"),
        (dataclasses.replace(cfg, ctc=tc.CTCConfig(use_beam=True, lm_path=wrong_lm)), {},
         ValueError, "does not match the model vocabulary"),
        (cfg, {"device": ["cpu", "cpu"]}, NotImplementedError, "multi-device"),
    ]
    for c, kw, exc, what in refused:
        with pytest.raises(exc, match=what):
            infer.run_inference(c, model, fstate, _batches(examples), **{"device": "cpu", **kw})


def test_vocab_copy_matches_jax(tmp_path):
    """The port's copy of uasr.vocab loads, encodes and scores as the
    original does, TIMIT fold included."""
    path = tmp_path / "phones.txt"
    path.write_text("aa\nao\nq\nh#\n<pad>\nzh\n<unk>\n")
    ids = [0, 1, 2, 3, 4, 5, 6, 2, 0, 7]
    pairs = [(jax_load_vocab(str(path)), load_vocab(str(path))),
             (jax_load_vocab(str(path), add_blank=False), load_vocab(str(path), add_blank=False)),
             (jax_make_vocab(["aa", "ao", "zh"]), make_vocab(["aa", "ao", "zh"]))]
    for ref, got in pairs:
        assert (got.tokens, got.blank_id, got.unk_id) == (ref.tokens, ref.blank_id, ref.unk_id)
        assert got.encode(["zh", "aa", "xx"]) == ref.encode(["zh", "aa", "xx"])
        valid = [i for i in ids if i < len(ref)]
        assert got.decode(valid) == ref.decode(valid)
        for fold in (False, True):
            assert got.decode_for_scoring(valid, fold) == ref.decode_for_scoring(valid, fold)


# a TIMIT-named vocabulary of the fixture's size: 'ao' folds to 'aa', 'pcl'
# to 'sil', 'ix' to 'ih', and 'q' is deleted before scoring
TIMIT_TOKENS = ["<blk>", "ao", "aa", "pcl", "q", "ix", "ih", "<unk>"]


def test_fold_timit_scores_and_writes_as_jax(trained, tmp_path):
    """ctc.fold_timit: per_folded and the folded hypothesis file equal the
    JAX package's run_inference(..., fold_timit=True)."""
    from uasr.vocab import Vocab as JaxVocab

    examples, vocab, jcfg, trainer, state = trained
    assert len(vocab) == len(TIMIT_TOKENS)
    jcfg = dataclasses.replace(jcfg, ctc=JaxCTCConfig(use_beam=False))
    j_hyp, t_hyp = tmp_path / "jax_hyp.txt", tmp_path / "torch_hyp.txt"
    ref = jax_run_inference(jcfg, trainer, state, _batches(examples),
                            vocab=JaxVocab(tokens=TIMIT_TOKENS), fold_timit=True,
                            hyp_path=str(j_hyp))
    cfg, model, fstate = _port({"use_beam": False, "fold_timit": True}, len(vocab),
                               state.params)
    got = infer.run_inference(cfg, model, fstate, _batches(examples),
                              vocab=Vocab(tokens=TIMIT_TOKENS), fold_timit=True,
                              hyp_path=str(t_hyp), device="cpu")
    assert "per_folded" in ref and got["per_folded"] == ref["per_folded"]
    for key in ("errors", "ref_tokens", "per"):
        assert got[key] == ref[key], key
    hyps = t_hyp.read_text()
    assert hyps == j_hyp.read_text() and len(hyps.splitlines()) == 16
    assert not {"ao", "pcl", "q", "ix"} & set(hyps.split())
    plain = infer.run_inference(cfg, model, fstate, _batches(examples),
                                vocab=Vocab(tokens=TIMIT_TOKENS), device="cpu")
    assert "per_folded" not in plain
