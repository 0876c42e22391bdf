"""The reference against the port's CPU path at small sizes: the same
inputs and weights give the same features, logits, losses, gradients,
updates and beams. Only this test imports both."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from benchmark.core import weights
from benchmark.reference import specaug
from benchmark.reference.adam import Adam
from benchmark.reference.beam import prefix_beam
from benchmark.reference.ctc import ctc_nll
from benchmark.reference.fbank import Fbank
from benchmark.reference.models import encode
from uasr_torch.config import FrontendConfig, ModelConfig
from uasr_torch.frontend.features import compute_features, make_frontend_state
from uasr_torch.frontend.specaugment import spec_augment
from uasr_torch.models.models import build_model
from uasr_torch.ops.ctc import ctc_loss
from uasr_torch.ops.decode import ctc_beam_search_decode
from uasr_torch.train import ClipAdam, make_schedule

FE = {"feature_type": "fbank", "num_mel_bins": 80, "cmvn": "utterance"}


def _audio(B=3, L=16000, seed=0):
    g = torch.Generator().manual_seed(seed)
    audio = 0.1 * torch.randn(B, L, generator=g)
    lens = torch.tensor([L, L * 3 // 4, L // 2 + 37])[:B]
    audio[torch.arange(L)[None, :] >= lens[:, None]] = 0
    return audio, lens


@pytest.mark.parametrize("cmvn", ["utterance", "streaming"])
def test_fbank_matches_the_port(cmvn):
    fe = dict(FE, cmvn=cmvn, streaming_chunk_frames=64 if cmvn == "streaming" else 0)
    cfg = FrontendConfig(**fe)
    audio, lens = _audio(L=16000 if cmvn == "utterance" else 3 * 10240 + 77)
    got, glen = compute_features(audio, lens, make_frontend_state(cfg, device="cpu"), cfg)
    fb = Fbank(fe, "cpu")
    ref, rlen = (fb.utterance if cmvn == "utterance" else fb.streaming)(audio, lens)
    assert torch.equal(glen, rlen)
    for b, n in enumerate(rlen.tolist()):
        d = (got[b, :n] - ref[b, :n]).norm() / ref[b, :n].norm()
        assert d < 1e-4, (b, float(d))


def _model(encoder: str, V: int, **kw):
    m = ModelConfig(encoder=encoder, dtype="float32", **kw)
    model = build_model(m, V, 80, device="cpu")
    shapes = {k: tuple(p.shape) for k, p in model.named_parameters()}
    W = weights.draw(shapes, 5, "cpu", {"emit_share": 0.3})
    weights.load_into(model, W)
    return model, W, dataclasses.asdict(m)


@pytest.mark.parametrize("encoder,kw", [
    ("conv_bigru", dict(hidden_size=16, num_gru_layers=2, conv_channels=4, num_conv_layers=2,
                        conv_time_stride=2, conv_kernel=3)),
    ("cnn", dict(hidden_size=24, num_conv_layers=2, conv_time_stride=2, conv_kernel=5)),
])
def test_encoders_match_the_port(encoder, kw):
    model, W, m = _model(encoder, 11, **kw)
    g = torch.Generator().manual_seed(1)
    feats = torch.randn(3, 57, 80, generator=g)
    lens = torch.tensor([57, 40, 9])
    feats[torch.arange(57)[None, :] >= lens[:, None]] = 0
    with torch.no_grad():
        got, glen = model(feats, lens)
        ref, rlen = encode(W, m, feats, lens)
    assert torch.equal(glen, rlen)
    for b, n in enumerate(rlen.tolist()):
        assert torch.allclose(got[b, :n], ref[b, :n], atol=1e-5, rtol=1e-4)


def test_ctc_loss_and_gradient_match_the_port():
    g = torch.Generator().manual_seed(2)
    logits = torch.randn(4, 30, 12, generator=g, requires_grad=True)
    lens, labels = torch.tensor([30, 22, 15, 9]), torch.randint(1, 12, (4, 8), generator=g)
    ulen = torch.tensor([8, 5, 0, 3])
    a = ctc_nll(torch.log_softmax(logits, -1), lens, labels, ulen)
    b = ctc_loss(logits, lens, labels, ulen, 0)
    assert torch.allclose(a, b, rtol=1e-5)
    ga, = torch.autograd.grad(a.mean(), logits)
    gb, = torch.autograd.grad(b.mean(), logits)
    assert torch.allclose(ga, gb, atol=1e-6)


def test_clipped_adam_and_schedule_match_the_port():
    from uasr_torch.config import Config, TrainConfig

    train = {"lr": 6e-4, "warmup_steps": 20, "lr_schedule": "warmup_rsqrt", "grad_clip": 5.0}
    g = torch.Generator().manual_seed(3)
    params = {"a": torch.randn(7, 5, generator=g), "b": torch.randn(5, generator=g)}
    ours = {k: v.clone() for k, v in params.items()}
    theirs = {k: v.clone() for k, v in params.items()}
    opt = Adam(ours, train)
    port = ClipAdam(make_schedule(Config(train=TrainConfig(**train))), 5.0)
    state = port.init(theirs)
    for step in range(3):
        grads = {k: (4.0 if step == 0 else 0.1) * torch.randn(v.shape, generator=g)
                 for k, v in params.items()}
        opt.step(ours, grads)
        upd, state, _ = port.update(grads, state)
        for k in theirs:
            theirs[k] += upd[k]
    for k in params:
        assert torch.allclose(ours[k], theirs[k], atol=1e-9, rtol=1e-6)


def test_specaugment_masks_match_the_port():
    fe = {"specaug_freq_mask": 27, "specaug_freq_masks": 2, "specaug_time_mask": 40,
          "specaug_time_masks": 2}
    feats = torch.randn(5, 120, 80) + 3.0
    lens = torch.tensor([120, 90, 60, 30, 7])
    got = spec_augment(torch.Generator().manual_seed(11 * 1_000_003 + 2), feats, lens,
                       FrontendConfig(**fe))
    keep = specaug.keep_mask(11, 2, 5, 120, 80, lens, fe)
    assert torch.equal(got, torch.where(keep, feats, 0.0))


@pytest.mark.parametrize("V,W,bias", [(32, 16, 2.0), (300, 8, 4.0), (5, 4, 0.0)])
def test_prefix_beam_matches_the_port(V, W, bias):
    g = torch.Generator().manual_seed(V)
    logits = 1.5 * torch.randn(6, 40, V, generator=g)
    logits[..., 0] += bias
    lens = torch.randint(1, 41, (6,), generator=g)
    ids, n, _ = ctc_beam_search_decode(logits, lens, W, 0)
    assert prefix_beam(torch.log_softmax(logits, -1), lens, W) == [
        ids[b, : n[b]].tolist() for b in range(6)]


def test_weights_are_a_function_of_the_seed():
    shapes = {"logits.weight": (5, 7), "logits.bias": (5,), "x.norm.weight": (7,),
              "g.wx": (2, 3, 12)}
    a, b = weights.draw(shapes, 9, "cpu"), weights.draw(shapes, 9, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in shapes)
    assert not torch.equal(a["g.wx"], weights.draw(shapes, 10, "cpu")["g.wx"])
    assert float(a["x.norm.weight"].min()) == 1.0 and not a["logits.bias"].any()
    assert np.isclose(float(a["g.wx"].std()), 3 ** -0.5, rtol=0.5)
