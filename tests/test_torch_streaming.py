"""The port's streaming frontend (uasr_torch.frontend.streaming) and K7's
plain version (cuda_frontend.log_mel_unfused_reference) against the JAX
package on the CPU: stream_chunk over several chunks with the Pallas
kernel in interpret mode and with the XLA path, the unfused log-mel in
each GEMM tier against _pallas_log_mel(fused=False), and the chunked
features against streaming_features and compute_features.

Bars: features 1e-4 (the frontend bar at precision "highest"); the
running statistics relative 1e-5 (they are sums over all frames so far,
~1e4 after a few chunks, where one float32 ulp is ~1e-3); the tiers as
tests/test_torch_frontend.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from uasr.config import FrontendConfig as JaxFrontendConfig
from uasr.frontend import streaming as jax_streaming
from uasr.frontend.features import compute_features as jax_compute_features
from uasr.frontend.features import make_frontend_state as jax_make_frontend_state
from uasr.frontend.pallas_frontend import _pallas_log_mel
from uasr_torch.config import FrontendConfig
from uasr_torch.frontend import cuda_frontend, streaming
from uasr_torch.frontend.features import compute_features, make_frontend_state

C = 16  # chunk frames: 2560 samples
S = C * 160
TIER_TOL = {"highest": 1e-4, "high": 5e-4, "bfloat16": 2e-2}


def _cfgs(**kw):
    kw = dict(num_mel_bins=40, cmvn="streaming", streaming_chunk_frames=C, **kw)
    return JaxFrontendConfig(**kw), FrontendConfig(**kw)


def _audio(seed, B=2, n_chunks=3):
    return (0.3 * np.random.RandomState(seed).randn(B, n_chunks * S)).astype(np.float32)


@pytest.mark.parametrize("use_pallas", [True, False], ids=["k7", "xla"])
def test_stream_chunk_matches_jax(use_pallas):
    jcfg, tcfg = _cfgs()
    jfe, tfe = jax_make_frontend_state(jcfg), make_frontend_state(tcfg, device="cpu")
    audio = _audio(0)
    jst = jax_streaming.init_stream_state(2, jcfg)
    tst = streaming.init_stream_state(2, tcfg)
    step = jax.jit(lambda st, ch: jax_streaming.stream_chunk(
        st, ch, jfe, jcfg, use_pallas=use_pallas, interpret=True))
    before = cuda_frontend.LAUNCHES_UNFUSED
    for k in range(3):
        chunk = audio[:, k * S:(k + 1) * S]
        jst, jf = step(jst, jnp.asarray(chunk))
        tst, tf = streaming.stream_chunk(tst, torch.tensor(chunk), tfe, tcfg,
                                         use_pallas=use_pallas)
        assert tf.shape == (2, C, 40)
        np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=0, atol=1e-4,
                                   err_msg=f"chunk {k}")
        for name, a, b in zip(tst._fields, jst, tst):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5, atol=1e-4,
                                       err_msg=f"chunk {k} {name}")
    assert cuda_frontend.LAUNCHES_UNFUSED == before  # CPU tensors: the plain version


@pytest.mark.parametrize("want_energy", [False, True])
@pytest.mark.parametrize("precision", sorted(TIER_TOL))
def test_log_mel_unfused_matches_pallas(precision, want_energy):
    jcfg, tcfg = _cfgs()
    jfe, tfe = jax_make_frontend_state(jcfg), make_frontend_state(tcfg, device="cpu")
    glued = _audio(1, n_chunks=1)[:, : 240 + S - 7]  # ragged tail: clamped last frame
    glued = np.concatenate([_audio(2, n_chunks=1)[:, :247], glued], 1)
    ref = jax.jit(lambda x: _pallas_log_mel(
        x, jfe, 400, 160, 512, block_frames=C, interpret=True, precision=precision,
        want_energy=want_energy))(jnp.asarray(glued))
    got = cuda_frontend.log_mel_unfused(torch.tensor(glued), tfe, tcfg, precision=precision,
                                        want_energy=want_energy)
    assert got.shape == ref.shape == (2, C, 40 + want_energy)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=TIER_TOL[precision])


def test_chunked_features_equal_streaming_features():
    """Feeding the chunks one at a time gives streaming_features' bits, and
    compute_features' streaming branch matches the JAX package's."""
    jcfg, tcfg = _cfgs()
    tfe = make_frontend_state(tcfg, device="cpu")
    audio = _audio(3)
    st = streaming.init_stream_state(2, tcfg)
    parts = []
    for k in range(3):
        st, f = streaming.stream_chunk(st, torch.tensor(audio[:, k * S:(k + 1) * S]), tfe, tcfg)
        parts.append(f)
    whole = streaming.streaming_features(torch.tensor(audio), tfe, tcfg)
    assert torch.equal(torch.cat(parts, 1), whole)

    lengths = np.array([3 * S, 2 * S - 100], np.int64)
    audio[1, lengths[1]:] = 0.0
    jf, jl = jax.jit(lambda a, n: jax_compute_features(a, n, jax_make_frontend_state(jcfg),
                                                       jcfg))(jnp.asarray(audio),
                                                              jnp.asarray(lengths))
    tf, tl = compute_features(torch.tensor(audio), torch.tensor(lengths), tfe, tcfg)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=0, atol=1e-4)
    assert not tf[1, int(tl[1]):].any()


def test_stream_chunk_rejects_ragged_chunk():
    _, tcfg = _cfgs()
    tfe = make_frontend_state(tcfg, device="cpu")
    with pytest.raises(ValueError, match="multiple of the frame shift"):
        streaming.stream_chunk(streaming.init_stream_state(1, tcfg), torch.zeros(1, S - 1),
                               tfe, tcfg)
