"""The port's streaming recognizer (uasr_torch.serve) and serving daemon
(uasr_torch.tools.serve_daemon) on the CPU.

Against the JAX package's StreamingRecognizer on the same converted cnn
weights (H = 32): per-chunk ids and counts and the finals, greedy and
beam, for a mixed-length batch, and the dynamic-batching primitives
(masked step with a length stamp, finish-and-reset, reset, stamp). Within
the port: streamed output equals the offline decode (greedy and beam 4),
the fused finalize tick equals its two parts, approximate window
streaming of a BiGRU matches the JAX package's, and the configurations it
must refuse. The causal recurrent encoders (uni_gru, lc_bigru, K5 through
its plain version) stream against the JAX package per chunk, greedy and
beam, and equal the port's offline decode; their dynamic-batching
primitives equal step-then-select (the JAX package's raise on lc_bigru's
carry). The daemon over localhost sockets mirrors
tests/test_serve_daemon.py; every wait in it is bounded (socket and queue
timeouts, joins with a deadline)."""

import dataclasses
import socket
import threading
import time

import numpy as np
import pytest
import torch

import jax

from uasr.config import Config as JaxConfig
from uasr.config import CTCConfig as JaxCTCConfig
from uasr.config import FrontendConfig as JaxFrontendConfig
from uasr.config import ModelConfig as JaxModelConfig
from uasr.models import build_model as jax_build_model
from uasr.serve import StreamingRecognizer as JaxRecognizer
from uasr_torch.config import (
    Config, CTCConfig, FrontendConfig, GANConfig, ModelConfig, TrainConfig,
)
from uasr_torch.convert import flax_to_state_dict
from uasr_torch.frontend import cuda_frontend
from uasr_torch.frontend.features import compute_features, make_frontend_state
from uasr_torch.models.models import build_model
from uasr_torch.ops import cuda_beam
from uasr_torch.ops.decode import ctc_beam_search_decode, ctc_greedy_decode
from uasr_torch.serve import StreamingRecognizer, streaming_receptive_field
from uasr_torch.tools.serve_daemon import ServingEngine, StreamClient, create_server

CHUNK = 32
CS = CHUNK * 160  # chunk samples
V = 10
WAIT = 60.0  # bound of every wait in the daemon tests


def _kw(beam: bool):
    return (dict(num_mel_bins=40, cmvn="streaming", streaming_chunk_frames=CHUNK),
            dict(encoder="cnn", hidden_size=32, num_conv_layers=2, conv_time_stride=2,
                 conv_kernel=5),
            dict(blank_id=0, use_beam=beam, beam_width=4))


def _cfg(beam: bool = False) -> Config:
    f, m, c = _kw(beam)
    return Config(name="serve_test", frontend=FrontendConfig(**f), model=ModelConfig(**m),
                  ctc=CTCConfig(**c), vocab_size=V)


def _jax_cfg(beam: bool = False) -> JaxConfig:
    f, m, c = _kw(beam)
    return JaxConfig(name="serve_test", frontend=JaxFrontendConfig(**f),
                     model=JaxModelConfig(**m), ctc=JaxCTCConfig(**c), vocab_size=V)


@pytest.fixture(scope="module")
def weights():
    """Seeded flax weights of the cnn encoder and the port's model on them."""
    cfg = _jax_cfg()
    params = jax_build_model(cfg.model, V).init(
        jax.random.PRNGKey(3), np.zeros((1, 4 * CHUNK, 40), np.float32), np.array([4 * CHUNK]))
    model = build_model(_cfg().model, V, 40, device="cpu")
    model.load_state_dict(flax_to_state_dict(jax.tree.map(np.asarray, params), _cfg().model))
    return params, model


def _batch(lens, seed=0):
    """Seeded audio of the given sample lengths, zero-padded to whole chunks."""
    lens = np.asarray(lens, np.int64)
    L = -(-int(lens.max()) // CS) * CS
    audio = (0.3 * np.random.RandomState(seed).randn(len(lens), L)).astype(np.float32)
    audio[np.arange(L)[None] >= lens[:, None]] = 0.0
    return audio, lens


MIXED = [5 * CS, 3 * CS + 100, 2 * CS - 7]


@pytest.mark.parametrize("beam", [False, True], ids=["greedy", "beam"])
def test_streaming_matches_jax(weights, beam):
    params, model = weights
    jrec = JaxRecognizer(_jax_cfg(beam), params)
    rec = StreamingRecognizer(_cfg(beam), model, device="cpu")
    audio, lens = _batch(MIXED)
    js, ts = jrec.init(3, lens), rec.init(3, lens)
    before = (cuda_frontend.LAUNCHES_UNFUSED, cuda_beam.LAUNCHES)
    emitted = 0
    for off in range(0, audio.shape[1], CS):
        js, jids, jn = jrec.step(js, audio[:, off:off + CS])
        ts, ids, n = rec.step(ts, audio[:, off:off + CS])
        np.testing.assert_array_equal(ids.numpy(), np.asarray(jids), err_msg=f"@{off}")
        np.testing.assert_array_equal(n.numpy(), np.asarray(jn), err_msg=f"@{off}")
        emitted += int(n.sum())
    js, jids, jn = jrec.finish(js)
    ts, ids, n = rec.finish(ts)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
    assert emitted > 0 and int(n.sum()) > 0
    if beam:
        for name in ("p_b", "p_nb"):
            np.testing.assert_allclose(getattr(ts.beam, name).numpy(),
                                       np.asarray(getattr(js.beam, name)), rtol=0, atol=1e-4)
    assert (cuda_frontend.LAUNCHES_UNFUSED, cuda_beam.LAUNCHES) == before  # plain versions


def _offline(model, cfg, audio, lens):
    """The port's offline decode of chunk-padded audio: token lists."""
    with torch.inference_mode():
        feats, flen = compute_features(torch.tensor(audio), torch.tensor(lens),
                                       make_frontend_state(cfg.frontend, device="cpu"),
                                       cfg.frontend)
        logits, n = model(feats, flen)
        if cfg.ctc.use_beam:
            ids, k, _ = ctc_beam_search_decode(logits, n, cfg.ctc.beam_width, cfg.ctc.blank_id)
        else:
            ids, k = ctc_greedy_decode(logits, n, cfg.ctc.blank_id)
    return [ids[b, : int(k[b])].tolist() for b in range(len(lens))]


def _streamed(rec, audio, lens):
    st = rec.init(len(lens), lens)
    got = [[] for _ in lens]
    for off in range(0, audio.shape[1], CS):
        st, ids, n = rec.step(st, audio[:, off:off + CS])
        for b in range(len(lens)):
            got[b] += ids[b, : int(n[b])].tolist()
    _, ids, n = rec.finish(st)
    if rec.use_beam:
        got = [[] for _ in lens]
    for b in range(len(lens)):
        got[b] += ids[b, : int(n[b])].tolist()
    return got


@pytest.mark.parametrize("beam", [False, True], ids=["greedy", "beam"])
def test_streamed_equals_offline(weights, beam):
    _, model = weights
    cfg = _cfg(beam)
    audio, lens = _batch(MIXED, seed=1)
    rec = StreamingRecognizer(cfg, model, device="cpu")
    assert _streamed(rec, audio, lens) == _offline(model, cfg, audio, lens)


def test_dynamic_batching_primitives_match_jax(weights):
    """Slots of different ages through masked steps (one stamping its
    length in the same call), finish-and-reset, reset and stamp, against
    the JAX package's primitives (beam mode: every state leaf is carried)."""
    params, model = weights
    jrec = JaxRecognizer(_jax_cfg(True), params)
    rec = StreamingRecognizer(_cfg(True), model, device="cpu")
    audio, lens = _batch([4 * CS, 4 * CS, 3 * CS - 50], seed=2)
    chunk = lambda k: audio[:, k * CS:(k + 1) * CS]  # noqa: E731
    js, ts = jrec.init(3), rec.init(3)
    plan = [  # (chunk index, mask, stamp mask)
        (0, [True, False, True], None),
        (1, [True, True, True], None),
        (2, [False, True, True], [False, False, True]),
        (3, [True, True, False], None),
    ]
    for k, mask, smask in plan:
        stamp = {} if smask is None else dict(stamp_mask=smask, stamp_samples=lens)
        js, jout = jrec.masked_step(js, chunk(k), np.array(mask), packed=True, **stamp)
        ts, tout = rec.masked_step(ts, chunk(k), np.array(mask), packed=True, **stamp)
        np.testing.assert_array_equal(tout.numpy(), np.asarray(jout), err_msg=f"step {k}")
    js = jrec.set_valid_samples(js, np.array([True, False, False]), np.array([4 * CS - 9, 0, 0]))
    ts = rec.set_valid_samples(ts, np.array([True, False, False]), np.array([4 * CS - 9, 0, 0]))
    fmask = np.array([True, False, True])
    js, jout = jrec.finish_and_reset(js, fmask, packed=True)
    ts, tout = rec.finish_and_reset(ts, fmask, packed=True)
    for b in (0, 2):  # finish columns are meaningful for the finishing slots
        np.testing.assert_array_equal(tout[b].numpy(), np.asarray(jout)[b])
    js = jrec.reset_slots(js, np.array([False, True, False]))
    ts = rec.reset_slots(ts, np.array([False, True, False]))
    live = (np.maximum(np.asarray(js.beam.p_b), np.asarray(js.beam.p_nb)) > -1e29)
    for name, a, b in _named_leaves(js, ts):
        a = np.asarray(a)
        if name in ("hash1", "hash2"):
            # live beams only: the packages' sentinels for dead beams differ
            a, b = a.astype(np.uint32)[live], b.numpy().astype(np.uint32)[live]
            np.testing.assert_array_equal(b, a, err_msg=name)
        elif b.dtype == torch.float32:
            np.testing.assert_allclose(b.numpy(), a, rtol=1e-5, atol=1e-4, err_msg=name)
        else:
            np.testing.assert_array_equal(b.numpy(), a.astype(b.numpy().dtype), err_msg=name)


def _named_leaves(jax_state, state):
    """(field name, JAX leaf, port leaf) over two nested states."""
    for name, a, b in zip(state._fields, jax_state, state):
        if isinstance(b, tuple):
            yield from _named_leaves(a, b)
        else:
            yield name, a, b


def _leaves(state):
    for x in state:
        if isinstance(x, tuple):
            yield from _leaves(x)
        else:
            yield x


def test_fused_step_and_finish_matches_separate_calls(weights):
    _, model = weights
    rec = StreamingRecognizer(_cfg(), model, device="cpu")
    audio, lens = _batch([3 * CS, 3 * CS - 300, 2 * CS], seed=3)
    st = rec.init(3)
    for k in range(2):
        st, _, _ = rec.masked_step(st, audio[:, k * CS:(k + 1) * CS], np.ones(3, bool))
    chunks = audio[:, 2 * CS:3 * CS].copy()
    chunks[2] = 0.0
    mask, fmask = np.array([True, True, False]), np.array([False, False, True])
    smask, samples = np.array([False, True, False]), lens
    st_a, sout_a, fout_a = rec.masked_step_and_finish(st, chunks, mask, fmask, smask, samples)
    st_b, sout_b = rec.masked_step(st, chunks, mask, smask, samples, packed=True)
    st_b, fout_b = rec.finish_and_reset(st_b, fmask, packed=True)
    assert torch.equal(sout_a, sout_b) and torch.equal(fout_a[2], fout_b[2])
    for a, b in zip(_leaves(st_a), _leaves(st_b)):
        assert torch.equal(a, b)


def test_approx_context_bigru_matches_jax():
    """Window-bounded streaming of a BiGRU encoder (approx_context; the
    recurrence through K2's plain version) against the JAX package's on
    the same converted weights, per chunk; without the opt-in the
    encoder is refused."""
    f, _, c = _kw(False)
    m = dict(encoder="conv_bigru", hidden_size=16, num_gru_layers=1, conv_channels=4,
             conv_kernel=5)
    jcfg = JaxConfig(name="t", frontend=JaxFrontendConfig(**f), model=JaxModelConfig(**m),
                     ctc=JaxCTCConfig(**c), vocab_size=V)
    cfg = Config(name="t", frontend=FrontendConfig(**f), model=ModelConfig(gru_pallas=True, **m),
                 ctc=CTCConfig(**c), vocab_size=V)
    params = jax_build_model(jcfg.model, V).init(
        jax.random.PRNGKey(4), np.zeros((1, 4 * CHUNK, 40), np.float32), np.array([4 * CHUNK]))
    model = build_model(cfg.model, V, 40, device="cpu")
    model.load_state_dict(flax_to_state_dict(jax.tree.map(np.asarray, params), cfg.model))
    with pytest.raises(ValueError, match="unbounded context"):
        StreamingRecognizer(cfg, model, device="cpu")
    jrec = JaxRecognizer(jcfg, params, lookback_frames=2 * CHUNK, approx_context=True)
    rec = StreamingRecognizer(cfg, model, lookback_frames=2 * CHUNK, approx_context=True,
                              device="cpu")
    assert rec.approx and (rec.subsample, rec.window) == (4, 4 * CHUNK)
    audio, lens = _batch([6 * CS, 4 * CS + 40], seed=4)  # the window rolls
    js, ts = jrec.init(2, lens), rec.init(2, lens)
    for off in range(0, audio.shape[1], CS):
        js, jids, jn = jrec.step(js, audio[:, off:off + CS])
        ts, ids, n = rec.step(ts, audio[:, off:off + CS])
        np.testing.assert_array_equal(ids.numpy(), np.asarray(jids), err_msg=f"@{off}")
        np.testing.assert_array_equal(n.numpy(), np.asarray(jn), err_msg=f"@{off}")
    (_, jids, jn), (_, ids, n) = jrec.finish(js), rec.finish(ts)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))


def test_rejections(weights):
    _, model = weights
    cfg = _cfg()
    assert streaming_receptive_field(cfg.model) == (2 + 4 + 8 + 16, 2)
    rec = StreamingRecognizer(cfg, model, device="cpu")
    assert (rec.lookback, rec.window) == (32, 96)
    with pytest.raises(ValueError, match="exactly"):
        rec.step(rec.init(1), np.zeros((1, CS - 160), np.float32))
    bad = [
        (dict(frontend=dataclasses.replace(cfg.frontend, cmvn="utterance")), ValueError,
         "cmvn: streaming"),
        (dict(frontend=dataclasses.replace(cfg.frontend, downsample=2)), ValueError,
         "downsample"),
        (dict(frontend=dataclasses.replace(cfg.frontend, streaming_chunk_frames=16)),
         ValueError, "half-width"),
        (dict(frontend=dataclasses.replace(cfg.frontend, streaming_chunk_frames=33)),
         ValueError, "multiple of the encoder subsampling"),
        (dict(model=dataclasses.replace(cfg.model, encoder="lc_bigru", lc_chunk=4)), ValueError,
         "chunk grid"),
        (dict(model=dataclasses.replace(cfg.model, encoder="transformer")), ValueError,
         "unbounded context"),
        (dict(ctc=dataclasses.replace(cfg.ctc, lm_path="lm.arpa", use_beam=True)),
         NotImplementedError, "load_lm"),
        (dict(train=TrainConfig(mode="gan"), gan=GANConfig(merge_repeats=True,
                                                           segmenter="kmeans")),
         ValueError, "segmenter"),
    ]
    for change, exc, match in bad:
        with pytest.raises(exc, match=match):
            StreamingRecognizer(dataclasses.replace(cfg, **change), model, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            StreamingRecognizer(cfg, model)


# ---------------------------------------------------------------- daemon


def _drain_final(sess, timeout=WAIT):
    partials, deadline = [], time.time() + timeout
    while True:
        kind, ids = sess.events.get(timeout=max(0.1, deadline - time.time()))
        if kind == "final":
            return partials, ids
        partials.extend(ids)


def _three(seed=5):
    lens = [CS + 777, 3 * CS - 20, 4 * CS + 5]
    audio, lens = _batch(lens, seed=seed)
    return [audio[b, : lens[b]] for b in range(3)], audio, lens


def test_engine_dynamic_join_leave_reuse(weights):
    """3 staggered streams through 2 slots: the third reuses a freed slot;
    every final equals the offline decode."""
    _, model = weights
    cfg = _cfg()
    audios, audio, lens = _three()
    ref = _offline(model, cfg, audio, lens)
    engine = ServingEngine(StreamingRecognizer(cfg, model, device="cpu"), linger_s=0.0)
    engine.start(2)
    try:
        s0, s1 = engine.open(), engine.open()
        assert engine.open() is None  # both slots taken
        piece = CS + CS // 2
        for a, sess in ((audios[0], s0), (audios[1], s1)):
            for off in range(0, len(a), piece):
                engine.feed(sess, a[off:off + piece])
                time.sleep(0.01)
        engine.end(s0)
        _, final0 = _drain_final(s0)
        deadline = time.time() + WAIT
        s2 = engine.open()
        while s2 is None and time.time() < deadline:
            time.sleep(0.02)
            s2 = engine.open()
        assert s2 is not None and s2.slot == s0.slot
        engine.feed(s2, audios[2])
        engine.end(s2)
        engine.end(s1)
        _, final1 = _drain_final(s1)
        _, final2 = _drain_final(s2)
        assert [final0, final1, final2] == ref
    finally:
        engine.stop()
    assert not engine._thread.is_alive()


def test_engine_beam_mode_staggered(weights):
    _, model = weights
    cfg = _cfg(beam=True)
    audios, audio, lens = _three(seed=6)
    ref = _offline(model, cfg, audio[:2], lens[:2])
    engine = ServingEngine(StreamingRecognizer(cfg, model, device="cpu"), linger_s=0.0)
    engine.start(2)
    try:
        s0 = engine.open()
        engine.feed(s0, audios[0][: 2 * CS])  # s0 two chunks ahead
        time.sleep(0.2)
        s1 = engine.open()
        engine.feed(s0, audios[0][2 * CS:])
        engine.feed(s1, audios[1])
        engine.end(s0)
        engine.end(s1)
        assert [_drain_final(s0)[1], _drain_final(s1)[1]] == ref
    finally:
        engine.stop()


def test_engine_linger_keeps_every_chunk(weights):
    """With a batching window (linger) and an idle second client, every
    tick lingers for co-arriving chunks while the first client's buffer
    holds several: none of its chunks may be dropped or stepped twice in
    a tick (the JAX package's engine loses one there). The engine's tick
    statistics count the 5 + 3 chunks and the 5 windows waited while the
    second client was live and idle."""
    _, model = weights
    cfg = _cfg()
    audios, audio, lens = _three(seed=9)
    ref = _offline(model, cfg, audio, lens)
    engine = ServingEngine(StreamingRecognizer(cfg, model, device="cpu"), linger_s=0.01)
    engine.start(2)
    try:
        s0, s1 = engine.open(), engine.open()
        engine.feed(s0, audios[2])  # five chunks at once; s1 stays idle
        engine.end(s0)
        _, final0 = _drain_final(s0)
        engine.feed(s1, audios[1])
        engine.end(s1)
        _, final1 = _drain_final(s1)
        assert [final0, final1] == [ref[2], ref[1]]
        stats = engine.stats
        assert stats.chunks == 8 and stats.ticks >= 8 and stats.lingers == 5
        assert stats.linger_s >= 5 * 0.01 and stats.busy_s > 0
    finally:
        engine.stop()


@pytest.fixture
def served(weights):
    _, model = weights
    server, engine = create_server(_cfg(), model, port=0, batch=2, chunk_frames=CHUNK,
                                   linger_s=0.0, device="cpu")
    srv = threading.Thread(target=server.serve_forever, daemon=True)
    srv.start()
    yield server, engine
    server.shutdown()
    server.server_close()
    engine.stop()
    srv.join(WAIT)
    assert not srv.is_alive()


def test_daemon_sockets_concurrent_and_busy(weights, served):
    """TCP round trip: concurrent clients, a busy refusal at capacity, slot
    reuse after a client finishes."""
    _, model = weights
    server, engine = served
    host, port = server.server_address[:2]
    audios, audio, lens = _three(seed=7)
    ref = _offline(model, _cfg(), audio, lens)
    c0, c1 = StreamClient(host, port, timeout=WAIT), StreamClient(host, port, timeout=WAIT)
    assert c0.start() == c1.start() == engine.chunk_samples == CS
    busy = StreamClient(host, port, timeout=WAIT)
    with pytest.raises(RuntimeError, match="busy"):
        busy.start()
    busy.close()
    results = {}

    def run(client, a, key):
        client.send_audio(a[: len(a) // 2])
        time.sleep(0.05)
        client.send_audio(a[len(a) // 2:])
        results[key] = client.finish()

    threads = [threading.Thread(target=run, args=(c, audios[i], i)) for i, c in
               enumerate((c0, c1))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(WAIT)
        assert not t.is_alive()
    assert [results[0], results[1]] == ref[:2]
    deadline = time.time() + WAIT
    while True:  # the freed slot comes back
        c2 = StreamClient(host, port, timeout=WAIT)
        try:
            c2.start()
            break
        except RuntimeError:
            c2.close()
            assert time.time() < deadline
            time.sleep(0.05)
    c2.send_audio(audios[2])
    assert c2.finish() == ref[2]


def test_daemon_dead_client_frees_slot(weights, served):
    _, model = weights
    server, engine = served
    host, port = server.server_address[:2]
    audios, audio, lens = _three(seed=8)
    ref = _offline(model, _cfg(), audio[:1], lens[:1])
    ghost = StreamClient(host, port, timeout=WAIT)
    ghost.start()
    ghost.send_audio(audios[1][:CS])
    live = StreamClient(host, port, timeout=WAIT)
    live.start()
    live.send_audio(audios[0])
    ghost.sock.shutdown(socket.SHUT_RDWR)  # vanish mid-stream
    ghost.sock.close()
    assert live.finish() == ref[0]
    deadline = time.time() + WAIT
    while len(engine._free) < 2 and time.time() < deadline:
        time.sleep(0.05)
    assert len(engine._free) == 2


# ---------------------------------------------------------------- recurrent


def _rec_kw(encoder: str, beam: bool):
    f, _, c = _kw(beam)
    m = dict(encoder=encoder, hidden_size=16, num_gru_layers=2, num_conv_layers=2,
             conv_time_stride=2, conv_kernel=5, lc_chunk=CHUNK // 4, lc_lookahead=4)
    return f, m, c


def _rec_cfgs(encoder: str, beam: bool = False):
    f, m, c = _rec_kw(encoder, beam)
    cfg = Config(name="t", frontend=FrontendConfig(**f), model=ModelConfig(gru_pallas=True, **m),
                 ctc=CTCConfig(**c), vocab_size=V)
    jcfg = JaxConfig(name="t", frontend=JaxFrontendConfig(**f), model=JaxModelConfig(**m),
                     ctc=JaxCTCConfig(**c), vocab_size=V)
    return cfg, jcfg


@pytest.fixture(scope="module")
def rec_weights():
    """Seeded flax weights of each recurrent encoder and the port's model on
    them (the JAX side runs its lax.scan GRU, the port its K5 path)."""
    out = {}
    for enc in ("uni_gru", "lc_bigru"):
        cfg, jcfg = _rec_cfgs(enc)
        params = jax_build_model(jcfg.model, V).init(
            jax.random.PRNGKey(5), np.zeros((1, 4 * CHUNK, 40), np.float32),
            np.array([4 * CHUNK]))
        model = build_model(cfg.model, V, 40, device="cpu")
        model.load_state_dict(flax_to_state_dict(jax.tree.map(np.asarray, params), cfg.model))
        out[enc] = params, model
    return out


@pytest.mark.parametrize("beam", [False, True], ids=["greedy", "beam"])
@pytest.mark.parametrize("encoder", ["uni_gru", "lc_bigru"])
def test_recurrent_streaming_matches_jax(rec_weights, encoder, beam):
    """Per chunk ids and counts, and the finals, against the JAX package's
    recognizer on the same weights, for a mixed-length batch."""
    params, model = rec_weights[encoder]
    cfg, jcfg = _rec_cfgs(encoder, beam)
    jrec = JaxRecognizer(jcfg, params)
    rec = StreamingRecognizer(cfg, model, device="cpu")
    assert rec.recurrent and rec.lookback == 0 and rec.delay == (2 if encoder == "lc_bigru" else 0)
    audio, lens = _batch(MIXED, seed=11)
    js, ts = jrec.init(3, lens), rec.init(3, lens)
    emitted = 0
    for off in range(0, audio.shape[1], CS):
        js, jids, jn = jrec.step(js, audio[:, off:off + CS])
        ts, ids, n = rec.step(ts, audio[:, off:off + CS])
        np.testing.assert_array_equal(ids.numpy(), np.asarray(jids), err_msg=f"@{off}")
        np.testing.assert_array_equal(n.numpy(), np.asarray(jn), err_msg=f"@{off}")
        emitted += int(n.sum())
    js, jids, jn = jrec.finish(js)
    ts, ids, n = rec.finish(ts)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
    assert emitted + int(n.sum()) > 0


@pytest.mark.parametrize("beam", [False, True], ids=["greedy", "beam"])
@pytest.mark.parametrize("encoder", ["uni_gru", "lc_bigru"])
def test_recurrent_streamed_equals_offline(rec_weights, encoder, beam):
    """Counterparts of tests/test_serve.py's uni_gru and lc_bigru streaming
    tests (greedy and beam): the streamed transcript of a mixed-length batch
    equals the port's offline decode, uni_gru with zero right-context
    latency, lc_bigru with its num_gru_layers-chunk lag flushed by finish."""
    _, model = rec_weights[encoder]
    cfg, _ = _rec_cfgs(encoder, beam)
    audio, lens = _batch([5 * CS + 300, 2 * CS - 7, 4 * CS], seed=12)
    rec = StreamingRecognizer(cfg, model, device="cpu")
    got = _streamed(rec, audio, lens)
    assert got == _offline(model, cfg, audio, lens)
    assert any(got)


def _slot(state, b: int, encoder: str) -> list:
    """Slot b of every leaf of a recurrent state (uni_gru's GRU state
    [L, B, H] has the batch on axis 1, every other leaf leads with it)."""
    h = state.carry[1] if encoder == "uni_gru" else None
    return [x[:, b] if x is h else x[b] for x in _leaves(state)]


@pytest.mark.parametrize("encoder", ["uni_gru", "lc_bigru"])
def test_recurrent_primitives_equal_step_then_select(rec_weights, encoder):
    """masked_step, finish_and_reset and reset_slots over both recurrent
    carries (uni_gru's [L, B, H] state, lc_bigru's (tail, buffers, forward
    states)) equal a full step followed by a per-slot select: stepped slots
    take the step's state, the others keep theirs bit for bit."""
    _, model = rec_weights[encoder]
    cfg, _ = _rec_cfgs(encoder, True)
    rec = StreamingRecognizer(cfg, model, device="cpu")
    audio, _ = _batch([4 * CS, 4 * CS, 3 * CS - 50], seed=13)
    st = rec.init(3)
    for k, mask in enumerate([[True, False, True], [True, True, True], [False, True, True]]):
        stepped, _, _ = rec.step(st, audio[:, k * CS:(k + 1) * CS])
        new, out = rec.masked_step(st, audio[:, k * CS:(k + 1) * CS], np.array(mask),
                                   packed=True)
        for b, m in enumerate(mask):
            for a, want in zip(_slot(new, b, encoder), _slot(stepped if m else st, b, encoder)):
                assert torch.equal(a, want), (k, b)
            if not m:
                assert out[b, -1] == 0
        st = new
    fmask = [True, False, True]
    _, ids, n = rec.finish(st)
    reset, out = rec.finish_and_reset(st, np.array(fmask), packed=True)
    fresh = rec.init(3)
    for b, m in enumerate(fmask):
        for a, want in zip(_slot(reset, b, encoder), _slot(fresh if m else st, b, encoder)):
            assert torch.equal(a, want)
        if m:
            assert out[b, -1] == n[b]
            assert torch.equal(out[b, : n[b]], ids[b, : n[b]].to(torch.int32))
    again = rec.reset_slots(reset, np.array([False, True, False]))  # now every slot is fresh
    for a, want in zip(_leaves(again), _leaves(fresh)):
        assert torch.equal(a, want)


def test_uni_gru_primitives_match_jax(rec_weights):
    """uni_gru's masked steps with a length stamp, finish-and-reset and
    reset against the JAX package's (which handle its [L, B, H] state)."""
    params, model = rec_weights["uni_gru"]
    cfg, jcfg = _rec_cfgs("uni_gru", True)
    jrec, rec = JaxRecognizer(jcfg, params), StreamingRecognizer(cfg, model, device="cpu")
    audio, lens = _batch([4 * CS, 4 * CS, 3 * CS - 50], seed=14)
    chunk = lambda k: audio[:, k * CS:(k + 1) * CS]  # noqa: E731
    js, ts = jrec.init(3), rec.init(3)
    plan = [(0, [True, False, True], None), (1, [True, True, True], [False, False, True]),
            (2, [False, True, True], None)]
    for k, mask, smask in plan:
        stamp = {} if smask is None else dict(stamp_mask=smask, stamp_samples=lens)
        js, jout = jrec.masked_step(js, chunk(k), np.array(mask), packed=True, **stamp)
        ts, tout = rec.masked_step(ts, chunk(k), np.array(mask), packed=True, **stamp)
        np.testing.assert_array_equal(tout.numpy(), np.asarray(jout), err_msg=f"step {k}")
    fmask = np.array([True, False, True])
    js, jout = jrec.finish_and_reset(js, fmask, packed=True)
    ts, tout = rec.finish_and_reset(ts, fmask, packed=True)
    for b in (0, 2):
        np.testing.assert_array_equal(tout[b].numpy(), np.asarray(jout)[b])
    js = jrec.reset_slots(js, np.array([False, True, False]))
    ts = rec.reset_slots(ts, np.array([False, True, False]))
    np.testing.assert_allclose(ts.carry[1].numpy(), np.asarray(js.carry[1]), rtol=0, atol=1e-5)
    np.testing.assert_allclose(ts.carry[0].numpy(), np.asarray(js.carry[0]), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(ts.n_frames.numpy(), np.asarray(js.n_frames))


def test_jax_masked_step_raises_on_lc_bigru(rec_weights):
    """The reference-side fault the port fixes (ROADMAP.md Queue 3): the
    JAX package's _select_slots treats lc_bigru's carry (tail, buffers,
    forward states) as uni_gru's (tail, h) and raises; the port's
    masked_step serves it."""
    params, model = rec_weights["lc_bigru"]
    cfg, jcfg = _rec_cfgs("lc_bigru")
    audio, _ = _batch([2 * CS, 2 * CS], seed=15)
    jrec = JaxRecognizer(jcfg, params)
    with pytest.raises(TypeError, match="where requires ndarray"):
        jrec.masked_step(jrec.init(2), audio[:, :CS], np.array([True, False]))
    rec = StreamingRecognizer(cfg, model, device="cpu")
    st, ids, n = rec.masked_step(rec.init(2), audio[:, :CS], np.array([True, False]))
    assert ids.shape == (2, CHUNK // 4) and list(n) == [0, 0]  # the lag: nothing yet


def test_engine_lc_bigru_finals_equal_offline(rec_weights):
    """lc_bigru through the serving engine: two staggered streams on two
    slots, a third reusing a freed slot; finals equal the offline decode."""
    _, model = rec_weights["lc_bigru"]
    cfg, _ = _rec_cfgs("lc_bigru")
    audios, audio, lens = _three(seed=16)
    ref = _offline(model, cfg, audio, lens)
    engine = ServingEngine(StreamingRecognizer(cfg, model, device="cpu"), linger_s=0.0)
    engine.start(2)
    try:
        s0, s1 = engine.open(), engine.open()
        engine.feed(s0, audios[0])
        engine.end(s0)
        engine.feed(s1, audios[1][: CS + 5])
        _, final0 = _drain_final(s0)
        deadline = time.time() + WAIT
        s2 = engine.open()
        while s2 is None and time.time() < deadline:
            time.sleep(0.02)
            s2 = engine.open()
        assert s2 is not None
        engine.feed(s2, audios[2])
        engine.feed(s1, audios[1][CS + 5:])
        engine.end(s1)
        engine.end(s2)
        assert [final0, _drain_final(s1)[1], _drain_final(s2)[1]] == ref
    finally:
        engine.stop()
    assert not engine._thread.is_alive()
