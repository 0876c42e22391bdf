"""K1 and K7 (csrc/log_mel.cu) on the CPU: what their launch needs from the
frontend state and the launch plan, and their plain versions at an FFT size
the kernels once refused.

- The mel runs of the port's state (each filter's nonzero bins [lo, hi),
  which the kernels sum over) against the JAX package's filterbank.
- ``cuda_frontend.launch_plan``, a pure function, at the main path's shapes,
  at n_fft 1024 / 50 ms frames, and past the shared memory a block may use.
- K1's and K7's plain versions at 50 ms frames and n_fft 1024 against
  ``_pallas_log_mel`` in interpret mode, in every tier at the frontend's
  bars (tests/test_torch_frontend.py)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from uasr.config import FrontendConfig as JaxFrontendConfig
from uasr.frontend.features import make_frontend_state as jax_make_state
from uasr.frontend.pallas_frontend import _pallas_log_mel
from uasr_torch.config import FrontendConfig
from uasr_torch.frontend import cuda_frontend
from uasr_torch.frontend.features import make_frontend_state

TIER_TOL = {"highest": 1e-4, "high": 5e-4, "bfloat16": 2e-2}


@pytest.mark.parametrize("n_fft", [512, 1024])
@pytest.mark.parametrize("num_mel_bins", [40, 80])
def test_mel_runs_are_the_jax_filterbanks_nonzero_runs(num_mel_bins, n_fft):
    kw = dict(num_mel_bins=num_mel_bins, n_fft=n_fft)
    fb = np.asarray(jax_make_state(JaxFrontendConfig(**kw)).mel_fb, np.float32)
    state = make_frontend_state(FrontendConfig(**kw), device="cpu")
    runs, w = state.mel_runs.numpy(), state.mel_w.numpy()
    assert runs.shape == (3, num_mel_bins) and runs.dtype == np.int32
    for m in range(num_mel_bins):
        lo, hi, off = runs[:, m]
        nz = np.flatnonzero(fb[:, m])
        if nz.size:
            assert (lo, hi) == (nz[0], nz[-1] + 1), m
        else:
            assert lo == hi == 0, m
        outside = np.ones(fb.shape[0], bool)
        outside[lo:hi] = False
        assert not fb[outside, m].any(), m
        np.testing.assert_array_equal(w[off:off + hi - lo], fb[lo:hi, m])
    assert w.size == int(runs[1].sum() - runs[0].sum())


# (B, L, unfused, tier) -> the recorded plan (frames a thread, warp rows,
# frames a CTA, slab rows, shared bytes, CTAs) on 132 SMs
MAIN_PLANS = {
    "k1_b32x16s_highest": ((32, 16 * 16000, False, "highest"), (8, 2, 64, 16, 144720, 800)),
    "k1_b32x16s_high": ((32, 16 * 16000, False, "high"), (2, 2, 16, 16, 124512, 3200)),
    "k1_b32x16s_bfloat16": ((32, 16 * 16000, False, "bfloat16"),
                            (8, 2, 64, 16, 144720, 800)),
    "k7_b64x64_highest": ((64, 240 + 64 * 160, True, "highest"), (4, 2, 32, 16, 154944, 128)),
    "k7_b64x32_highest": ((64, 240 + 32 * 160, True, "highest"), (4, 1, 16, 16, 129024, 128)),
}


@pytest.mark.parametrize("case", sorted(MAIN_PLANS))
def test_launch_plan_at_the_main_path_shapes(case):
    (B, L, unfused, tier), want = MAIN_PLANS[case]
    plan = cuda_frontend.launch_plan(B, L, 400, 160, 512, tier, unfused, sms=132)
    assert (plan["frames_per_thread"], plan["warp_rows"], plan["frames_per_cta"],
            plan["slab_rows"], plan["shared_bytes"], plan["ctas"]) == want
    assert plan["threads"] == 128 * plan["warp_rows"]
    assert plan["passes"] == 1 and plan["tail_bins"] == 1 and plan["power_over_ring"]
    assert plan["staging"] == ("frames" if unfused else "span")


def test_launch_plan_takes_nfft_1024_and_refuses_past_shared_memory():
    for unfused in (False, True):
        for tier in TIER_TOL:
            plan = cuda_frontend.launch_plan(4, 48000, 800, 160, 1024, tier, unfused)
            assert plan["passes"] == 2 and plan["tail_bins"] == 1
            assert not plan["power_over_ring"]
            assert plan["shared_bytes"] <= cuda_frontend.MAX_SMEM
    # any batch: the grid is one-dimensional
    assert cuda_frontend.launch_plan(65536, 400, 400, 160, 512)["ctas"] == 65536
    # frames staged one by one where the shift is not a multiple of four
    assert cuda_frontend.launch_plan(2, 8000, 551, 221, 1024)["staging"] == "frames"
    with pytest.raises(ValueError, match="shared memory"):
        cuda_frontend.launch_plan(2, 20000, 3200, 160, 8192)
    with pytest.raises(ValueError, match="unknown frontend precision"):
        cuda_frontend.launch_plan(2, 4000, 400, 160, 512, "tf32")
    with pytest.raises(ValueError, match="built for the tiles"):
        cuda_frontend.launch_plan(2, 4000, 400, 160, 512, "high", tile=(8, 2))


FL50 = dict(num_mel_bins=40, frame_length_ms=50.0, n_fft=1024)


@pytest.fixture(scope="module")
def pallas_50ms():
    """_pallas_log_mel in interpret mode at 50 ms frames (FL = 800, n_fft
    1024), one jitted call per (fused, tier), shared by the cases."""
    jstate = jax_make_state(JaxFrontendConfig(**FL50))
    audio = (0.1 * np.random.RandomState(11).randn(2, 800 + 20 * 160)).astype(np.float32)
    cache = {}

    def ref(fused, tier):
        if (fused, tier) not in cache:
            cache[fused, tier] = np.asarray(jax.jit(lambda x: _pallas_log_mel(
                x, jstate, 800, 160, 1024, interpret=True, precision=tier, want_energy=True,
                fused=fused))(jnp.asarray(audio)))
        return cache[fused, tier]

    return audio, ref


@pytest.mark.parametrize("tier", sorted(TIER_TOL))
@pytest.mark.parametrize("fused", [True, False], ids=["k1", "k7"])
def test_plain_log_mel_at_50ms_frames_matches_pallas(pallas_50ms, fused, tier):
    audio, ref = pallas_50ms
    cfg = FrontendConfig(**FL50)
    assert (cfg.frame_length, cfg.n_fft) == (800, 1024)
    plain = (cuda_frontend.log_mel_fused_reference if fused
             else cuda_frontend.log_mel_unfused_reference)
    got = plain(torch.tensor(audio), make_frontend_state(cfg, device="cpu"), 800, 160, 1024,
                precision=tier, want_energy=True)
    want = ref(fused, tier)
    assert got.shape == want.shape == (2, 21, 41)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TIER_TOL[tier])
