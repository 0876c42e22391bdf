"""Streaming serving of a GAN / EODM checkpoint trained with
``gan.merge_repeats`` (the merged-stream collapse of
uasr_torch.serve.StreamingRecognizer) on the CPU.

Against the JAX package's StreamingRecognizer on the same converted
classifier weights (hidden 24, context 2, V = 8, 16 mel bins, streaming
CMVN, chunks of 16 frames, a mixed-length batch of 3): ids and counts of
every chunk and the finals equal. Within the port: the streamed tokens
equal the offline greedy decode of the merged stream
(``GeneratorInfer.logits_fn``), and the configurations it refuses."""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from uasr.config import Config as JaxConfig
from uasr.config import FrontendConfig as JaxFrontendConfig
from uasr.config import GANConfig as JaxGANConfig
from uasr.config import ModelConfig as JaxModelConfig
from uasr.config import TrainConfig as JaxTrainConfig
from uasr.models.models import build_model as jax_build_model
from uasr.serve import StreamingRecognizer as JaxRecognizer
from uasr_torch import config as tc
from uasr_torch.convert import flax_to_state_dict
from uasr_torch.data.dataset import make_synthetic_dataset
from uasr_torch.ops.decode import ctc_greedy_decode
from uasr_torch.serve import StreamingRecognizer
from uasr_torch.train import GeneratorInfer

V, CHUNK = 8, 16
CS = CHUNK * 160
KW = (dict(num_mel_bins=16, cmvn="streaming", streaming_chunk_frames=CHUNK),
      dict(encoder="classifier", classifier_hidden=24, classifier_layers=2,
           classifier_context=2),
      dict(merge_repeats=True), dict(mode="gan+eodm"))


def _cfg(**gan) -> tc.Config:
    f, m, g, t = KW
    return tc.Config(frontend=tc.FrontendConfig(**f), model=tc.ModelConfig(**m),
                     gan=tc.GANConfig(**{**g, **gan}), train=tc.TrainConfig(**t), vocab_size=V)


@pytest.fixture(scope="module")
def served():
    """Seeded flax classifier weights (the blank's logit bias raised so
    blank runs separate repeats), the port's generator on them, and a
    mixed-length batch of tone-language audio padded to whole chunks."""
    f, m, g, t = KW
    jcfg = JaxConfig(frontend=JaxFrontendConfig(**f), model=JaxModelConfig(**m),
                     gan=JaxGANConfig(**g), train=JaxTrainConfig(**t), vocab_size=V)
    params = jax_build_model(jcfg.model, V).init(
        jax.random.PRNGKey(4), np.zeros((1, 4 * CHUNK, 16), np.float32), np.array([4 * CHUNK]))
    params = jax.tree.map(np.array, params)  # writable copies
    params["params"]["logits"]["bias"][0] = 1.0
    ginf = GeneratorInfer(_cfg(), device="cpu")
    ginf.gen.load_state_dict(flax_to_state_dict(params, ginf.cfg))
    examples, _ = make_synthetic_dataset(num_utts=3, num_phones=V - 2, seed=3, min_len=6,
                                         max_len=9)
    lens = np.array([len(a) for a, _ in examples])
    L = -(-int(lens.max()) // CS) * CS
    audio = np.zeros((3, L), np.float32)
    for i, (a, _) in enumerate(examples):
        audio[i, : len(a)] = a
    return jcfg, params, ginf, audio, lens


def test_merged_stream_matches_jax(served):
    jcfg, params, ginf, audio, lens = served
    jrec = JaxRecognizer(jcfg, params)
    rec = StreamingRecognizer(ginf.cfg, ginf.gen, device="cpu")
    assert rec.collapse == jrec.collapse == "merge"
    js, ts = jrec.init(3, lens), rec.init(3, lens)
    emitted = 0
    for off in range(0, audio.shape[1], CS):
        js, jids, jn = jrec.step(js, audio[:, off:off + CS])
        ts, ids, n = rec.step(ts, audio[:, off:off + CS])
        np.testing.assert_array_equal(ids.numpy(), np.asarray(jids), err_msg=f"@{off}")
        np.testing.assert_array_equal(n.numpy(), np.asarray(jn), err_msg=f"@{off}")
        np.testing.assert_array_equal(ts.prev_id.numpy(), np.asarray(js.prev_id))
        emitted += int(n.sum())
    js, jids, jn = jrec.finish(js)
    ts, ids, n = rec.finish(ts)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
    assert emitted > 0


def _tokens(rec, audio, lens):
    st = rec.init(len(lens), lens)
    got = [[] for _ in lens]
    for off in range(0, audio.shape[1], CS):
        st, ids, n = rec.step(st, audio[:, off:off + CS])
        for b in range(len(lens)):
            got[b] += ids[b, : int(n[b])].tolist()
    _, ids, n = rec.finish(st)
    for b in range(len(lens)):
        got[b] += ids[b, : int(n[b])].tolist()
    return got


def test_streamed_equals_offline_merged_greedy(served):
    """The streamed tokens equal the offline greedy decode of the merged
    stream, and differ from a plain CTC collapse of the raw frames where a
    blank separates a repeat."""
    _, _, ginf, audio, lens = served
    rec = StreamingRecognizer(ginf.cfg, ginf.gen, device="cpu")
    streamed = _tokens(rec, audio, lens)
    with torch.no_grad():
        logits, n = ginf.logits_fn(torch.tensor(audio), torch.tensor(lens))
        ids, k = ctc_greedy_decode(logits, n, 0)
    offline = [ids[b, : int(k[b])].tolist() for b in range(len(lens))]
    assert streamed == offline and sum(map(len, offline)) > 3
    plain = StreamingRecognizer(dataclasses.replace(ginf.cfg, train=tc.TrainConfig()), ginf.gen,
                                device="cpu")
    assert plain.collapse == "ctc"
    raw = _tokens(plain, audio, lens)
    assert all(len(r) >= len(s) for r, s in zip(raw, streamed)) and raw != streamed


def test_merged_stream_refusals(served):
    _, _, ginf, _, _ = served
    cfg = _cfg(segmenter="kmeans")
    with pytest.raises(ValueError, match="segmenter"):
        StreamingRecognizer(cfg, ginf.gen, device="cpu")
    cfg = dataclasses.replace(_cfg(), ctc=tc.CTCConfig(use_beam=True))
    with pytest.raises(ValueError, match="greedy streaming"):
        StreamingRecognizer(cfg, ginf.gen, device="cpu")
    rec = StreamingRecognizer(_cfg(merge_repeats=False), ginf.gen, device="cpu")
    assert rec.collapse == "ctc"
