"""Port frontend (uasr_torch.frontend) against the JAX package on the CPU:
compute_features against the jitted JAX one, and K1's plain version
against the Pallas fused log-mel kernel in interpret mode."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from uasr.config import FrontendConfig as JaxFrontendConfig
from uasr.frontend.features import compute_features as jax_compute_features
from uasr.frontend.features import frontend_state_from_config as jax_state_from_config
from uasr.frontend.features import make_frontend_state as jax_make_state
from uasr.frontend.pallas_frontend import pallas_log_mel_frontend
from uasr_torch.config import FrontendConfig
from uasr_torch.frontend import cuda_frontend
from uasr_torch.frontend.features import (
    compute_features, frontend_state_from_config, make_frontend_state,
)


def _audio(B=3, L=4000, seed=0):
    rng = np.random.RandomState(seed)
    t = np.arange(L) / 16000.0
    audio = (0.5 * np.sin(2 * np.pi * 523.0 * t)[None] + 0.05 * rng.randn(B, L))
    lengths = np.array([L, L - 1500, 900, 4000][:B], np.int32)
    audio[np.arange(L)[None, :] >= lengths[:, None]] = 0.0
    return audio.astype(np.float32), lengths


FEATURE_CASES = {
    "fbank": {},
    "mfcc": {"feature_type": "mfcc"},
    "mfcc_energy": {"feature_type": "mfcc", "use_energy": True},
    "deltas_splice_downsample": {"add_deltas": True, "splice_left": 1,
                                 "splice_right": 1, "downsample": 2},
    "global_cmvn": {"cmvn": "global"},
    "no_cmvn_mfcc_deltas": {"cmvn": "none", "feature_type": "mfcc", "add_deltas": True},
}


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("case", sorted(FEATURE_CASES))
def test_compute_features_matches_jax(case, fused):
    kw = dict(num_mel_bins=24, **FEATURE_CASES[case])
    jcfg = JaxFrontendConfig(**kw)
    tcfg = FrontendConfig(use_pallas=fused, **kw)
    mean = std = None
    if kw.get("cmvn") == "global":
        rng = np.random.RandomState(3)
        mean = rng.randn(jcfg.base_dim).astype(np.float32)
        std = (1.0 + rng.rand(jcfg.base_dim)).astype(np.float32)
    audio, lengths = _audio()
    jstate = jax_make_state(jcfg, mean, std)
    jf, jl = jax.jit(lambda a, n: jax_compute_features(a, n, jstate, jcfg))(audio, lengths)
    tstate = make_frontend_state(tcfg, mean, std, device="cpu")
    tf, tl = compute_features(torch.tensor(audio), torch.tensor(lengths), tstate, tcfg)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert tf.shape == jf.shape
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=0, atol=1e-4)


@pytest.mark.parametrize("precision,atol", [("highest", 1e-4), ("high", 5e-4),
                                            ("bfloat16", 2e-2)])
@pytest.mark.parametrize("want_energy", [False, True])
def test_log_mel_fused_reference_matches_pallas(precision, atol, want_energy):
    cfg_kw = dict(num_mel_bins=40)
    jcfg, tcfg = JaxFrontendConfig(**cfg_kw), FrontendConfig(**cfg_kw)
    audio, _ = _audio(B=2, L=5000, seed=1)
    ref = pallas_log_mel_frontend(jnp.asarray(audio), jax_make_state(jcfg), jcfg,
                                  interpret=True, precision=precision,
                                  want_energy=want_energy)
    got = cuda_frontend.log_mel_fused_reference(
        torch.tensor(audio), make_frontend_state(tcfg, device="cpu"),
        tcfg.frame_length, tcfg.frame_shift, tcfg.n_fft, precision=precision,
        want_energy=want_energy)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=atol)


def test_log_mel_fused_on_cpu_runs_plain_version():
    """For CPU tensors the wrapper runs the plain version and counts no
    kernel launch; audio shorter than one frame still gives one frame."""
    cfg = FrontendConfig(num_mel_bins=16)
    state = make_frontend_state(cfg, device="cpu")
    before = cuda_frontend.LAUNCHES
    short = torch.tensor(_audio(B=2, L=300)[0])
    out = cuda_frontend.log_mel_fused(short, state, cfg)
    assert cuda_frontend.LAUNCHES == before
    assert out.shape == (2, 1, 16) and torch.isfinite(out).all()
    full = torch.tensor(_audio(B=2, L=2000)[0])
    np.testing.assert_array_equal(
        cuda_frontend.log_mel_fused(full, state, cfg).numpy(),
        cuda_frontend.log_mel_fused_reference(full, state, cfg.frame_length,
                                              cfg.frame_shift, cfg.n_fft).numpy())


def test_streaming_cmvn_not_ported():
    cfg = FrontendConfig(cmvn="streaming")
    audio, lengths = _audio(B=1)
    with pytest.raises(NotImplementedError, match="streaming"):
        compute_features(torch.tensor(audio), torch.tensor(lengths),
                         make_frontend_state(cfg, device="cpu"), cfg)


def test_frontend_state_from_config_matches_jax(tmp_path):
    """Global-CMVN statistics load from the stats file into the same
    constant bank as the JAX package's; a missing path or a statistics
    width other than base_dim raises."""
    kw = dict(num_mel_bins=24, feature_type="mfcc", add_deltas=True, cmvn="global")
    rng = np.random.RandomState(5)
    path = tmp_path / "cmvn.npz"
    dim = JaxFrontendConfig(**kw).base_dim
    np.savez(path, mean=rng.randn(dim), std=1.0 + rng.rand(dim))
    jstate = jax_state_from_config(JaxFrontendConfig(cmvn_stats_path=str(path), **kw))
    tstate = frontend_state_from_config(FrontendConfig(cmvn_stats_path=str(path), **kw),
                                        device="cpu")
    for name in jstate._fields:
        a, b = getattr(jstate, name), getattr(tstate, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)
    with pytest.raises(ValueError, match="cmvn_stats_path"):
        frontend_state_from_config(FrontendConfig(**kw), device="cpu")
    np.savez(path, mean=np.zeros(dim + 1), std=np.ones(dim + 1))
    with pytest.raises(ValueError, match="base_dim"):
        frontend_state_from_config(FrontendConfig(cmvn_stats_path=str(path), **kw),
                                   device="cpu")
