"""The port's CUDA kernels against their plain PyTorch versions on the card,
at small shapes and options that chip_smoke.py's full-width run does not
reach: audio shorter than one frame and the log-energy column (K1), batch
rows split over several passes and idle hidden units (K2), one-beam and
full-warp beams, V above a warp, a non-zero blank and zero lengths (K4),
and the encoder on CUDA against the same weights on the CPU.

Every test needs a CUDA card and skips without one. On the card, from the
repository root (the package ``uasr`` and JAX are not needed there):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from uasr_torch.config import FrontendConfig, ModelConfig
from uasr_torch.frontend import cuda_frontend
from uasr_torch.frontend.features import compute_features, make_frontend_state
from uasr_torch.models import cuda_gru
from uasr_torch.models.models import build_model
from uasr_torch.ops import cuda_beam

pytestmark = pytest.mark.cuda

K1_TOL = {"highest": 1e-4, "high": 5e-4, "bfloat16": 2e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@pytest.mark.parametrize("L", [300, 400, 561, 5000])
@pytest.mark.parametrize("want_energy", [False, True])
@pytest.mark.parametrize("precision", sorted(K1_TOL))
def test_log_mel_kernel_matches_plain(dev, precision, want_energy, L):
    cfg = FrontendConfig(num_mel_bins=40)
    state = make_frontend_state(cfg, device=dev)
    audio = torch.tensor(np.random.RandomState(L).randn(3, L).astype(np.float32) * 0.1,
                         device=dev)
    args = (audio, state, cfg.frame_length, cfg.frame_shift, cfg.n_fft)
    before = cuda_frontend.LAUNCHES
    got = cuda_frontend.log_mel_fused_cuda(*args, precision=precision, want_energy=want_energy)
    ref = cuda_frontend.log_mel_fused_reference(*args, precision=precision,
                                                want_energy=want_energy)
    torch.cuda.synchronize()
    assert cuda_frontend.LAUNCHES == before + 1
    assert got.shape == ref.shape == (3, max(1 + (L - 400) // 160, 1), 40 + want_energy)
    assert torch.isfinite(got).all()
    assert float((got - ref).abs().max()) <= K1_TOL[precision]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("T,B,H", [(9, 1, 8), (7, 5, 24), (6, 300, 16), (11, 40, 64)])
def test_bigru_kernel_matches_plain(dev, T, B, H, dtype, tol):
    gen = torch.Generator(device=dev).manual_seed(T * B + H)
    lengths = torch.randint(1, T + 1, (B,), device=dev, generator=gen)
    lengths[0] = T
    tpos = torch.arange(T, device=dev)[:, None]
    tmask = torch.stack([tpos < lengths[None], tpos >= (T - lengths)[None]], 1)
    p0, p1 = (0.5 * torch.randn(T, B, 3 * H, device=dev, generator=gen) for _ in range(2))
    wh = torch.randn(2, H, 3 * H, device=dev, generator=gen) / H ** 0.5
    bh = 0.1 * torch.randn(2, 3 * H, device=dev, generator=gen)
    args = tuple(x.to(dtype).contiguous() for x in (p0, p1, wh, bh)) + (tmask,)
    got = cuda_gru.bigru_scan_cuda(*args)
    ref = cuda_gru.bigru_scan_reference(*args)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (T, B, 2 * H)
    assert float((got.float() - ref.float()).abs().max()) <= tol


@pytest.mark.parametrize("H", [12, 16])
def test_bigru_kernel_rejects_bad_input(dev, H):
    """H = 12 is not a multiple of 8; at H = 16 wh is not contiguous."""
    x = torch.zeros(4, 2, 3 * H, device=dev)
    wh = torch.zeros(2, 3 * H, H, device=dev).transpose(1, 2)
    if H % 8:
        wh = wh.contiguous()
    bh, tm = torch.zeros(2, 3 * H, device=dev), torch.ones(4, 2, 2, device=dev)
    with pytest.raises(ValueError, match="multiple of 8" if H % 8 else "contiguous"):
        cuda_gru.bigru_scan_cuda(x, x, wh, bh, tm)


@pytest.mark.parametrize("lm_order", [0, 2, 3])
@pytest.mark.parametrize("W,V,blank", [(1, 5, 0), (3, 40, 2), (32, 7, 0), (8, 12, 11)])
def test_beam_kernel_matches_plain(dev, W, V, blank, lm_order):
    rng = np.random.RandomState(W * V + lm_order)
    B, T = 5, 23
    logp = torch.log_softmax(torch.tensor(rng.randn(B, T, V) * 3.0, dtype=torch.float32,
                                          device=dev), -1).contiguous()
    lengths = torch.tensor([T, 1, 0, 17, 9], device=dev)
    lm = None
    if lm_order:
        rows = (V + 1) ** (lm_order - 1)
        lm = torch.tensor(np.log(rng.dirichlet(np.ones(V), rows)), dtype=torch.float32,
                          device=dev)
    args = (logp, lengths, W, blank, lm, lm_order, 0.5, 0.3)
    got = cuda_beam.ctc_beam_cuda(*args)
    ref = cuda_beam.ctc_beam_reference(*args)
    torch.cuda.synchronize()
    for a, b in zip(got[:2], ref[:2]):  # backpointers bit-equal
        assert torch.equal(a, b)
    for a, b in zip(got[2:], ref[2:]):
        assert float((a - b).abs().max()) <= 1e-4
    ids, n, score = cuda_beam.beam_traceback(*got, blank)
    r_ids, r_n, r_score = cuda_beam.beam_traceback(*ref, blank)
    assert torch.equal(ids, r_ids) and torch.equal(n, r_n)
    assert float((score - r_score).abs().max()) <= 1e-4


@pytest.mark.parametrize("front", ["conv2d", "patch"])
def test_encoder_on_card_matches_cpu(dev, front):
    """Frontend (K1) and encoder (K2) on CUDA against the plain versions on
    the CPU, same seeded weights, float32."""
    fcfg = FrontendConfig(num_mel_bins=24)
    mcfg = ModelConfig(hidden_size=32, num_gru_layers=2, conv_channels=4, conv_front=front,
                       gru_pallas=True)
    rng = np.random.RandomState(7)
    audio = (0.1 * rng.randn(3, 6000)).astype(np.float32)
    alen = np.array([6000, 4100, 900])
    audio[np.arange(6000)[None] >= alen[:, None]] = 0.0
    outs = []
    for d in (dev, torch.device("cpu")):
        model = build_model(mcfg, 9, fcfg.dim_input, generator=torch.Generator().manual_seed(1),
                            device=d)
        fstate = make_frontend_state(fcfg, device=d)
        with torch.inference_mode():
            feats, flen = compute_features(torch.tensor(audio, device=d),
                                           torch.tensor(alen, device=d), fstate, fcfg)
            outs.append((feats.cpu(), flen.cpu(), *(x.cpu() for x in model(feats, flen))))
    (f_c, fl_c, lg_c, n_c), (f_p, fl_p, lg_p, n_p) = outs
    assert torch.equal(fl_c, fl_p) and torch.equal(n_c, n_p)
    assert float((f_c - f_p).abs().max()) <= 1e-4
    assert float((lg_c - lg_p).abs().max()) <= 1e-4


def test_wrappers_launch_only_for_cuda_tensors(dev):
    cfg = FrontendConfig(num_mel_bins=16)
    audio = torch.zeros(2, 800, device=dev)
    before = cuda_frontend.LAUNCHES
    cuda_frontend.log_mel_fused(audio, make_frontend_state(cfg, device=dev), cfg)
    cuda_frontend.log_mel_fused(audio.cpu(), make_frontend_state(cfg, device="cpu"), cfg)
    assert cuda_frontend.LAUNCHES == before + 1
    with pytest.raises(ValueError, match="unknown frontend precision"):
        cuda_frontend.log_mel_fused_cuda(audio, make_frontend_state(cfg, device=dev),
                                         cfg.frame_length, cfg.frame_shift, cfg.n_fft,
                                         precision="tf32")
