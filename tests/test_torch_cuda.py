"""The port's CUDA kernels against their plain PyTorch versions on the card,
at small shapes and options that chip_smoke.py's full-width run does not
reach: audio shorter than one frame and the log-energy column (K1, K7),
batch rows split over several passes and idle hidden units, B = 1, 4 and
7 at H = 512 and wh streamed at H = 1536 and 2304 (K2, also against K5),
one-beam and full-warp beams, V above a warp and at 4233, a non-zero
blank, zero lengths, and a decode fed in chunks from a carried state, at
V = 4233 with a bigram table too (K4;
also its main-path shapes, both sides of the cluster threshold, W = 32 at
the largest vocabulary, fewer live candidates than beams, determinism and
the phase-stamped build),
T = 1, odd T, one row, batch rows split over passes and wh streamed
(K2-bwd and its coefficient kernel alone), S from 1 to 8191, a non-zero
blank, zero-length rows, T and B around the ring's depth and the SM count,
every ring depth, act masks with holes and the phase-stamped builds (K3,
K3-bwd), the edges of
K5-bwd's tensor-core tiles and its coefficient kernel alone, K5's skipped
products of masked passes and warp tiles, wh streamed past shared memory
(K5, K5-bwd, K8 at H = 1536 and 2304), input each kernel must refuse, and
the encoder, one training step, the streaming recognizer, the HMM Viterbi
decode (bigram and trigram) and CTC forced alignment on CUDA against the
same weights or logits on the CPU; ``torch.library.opcheck`` of each
``uasr::`` operator on CUDA tensors, and the padding of ``torch._int_mm``
(int8_compute) against its plain version.

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
from uasr_torch.ops import cuda_adam, cuda_beam, cuda_ctc

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
    assert cuda_frontend.LAST_PLAN == _log_mel_plan(dev, 3, L, cfg, precision, False)
    assert got.shape == ref.shape == (3, max(1 + (L - 400) // 160, 1), 40 + want_energy)
    assert torch.isfinite(got).all()
    assert float((got - ref).abs().max()) <= K1_TOL[precision]


def _log_mel_plan(dev, B, L, cfg, precision, unfused):
    return cuda_frontend.launch_plan(B, L, cfg.frame_length, cfg.frame_shift, cfg.n_fft,
                                     precision, unfused,
                                     torch.cuda.get_device_properties(dev).multi_processor_count)


def _log_mel_held_to_plain(dev, unfused, audio, cfg, precision, want_energy=False):
    """Run K1 or K7 on [B, L] audio, assert its launch count and plan, and
    hold it to the plain version at the card's bar. The plain version runs
    on the rows repeated to at least 4096 frames: its f32 products are
    cuBLAS's, whose summation order follows the row count (at 64 x 32
    frames, 2048 rows, it splits the sums, and this kernel, like the one
    before it, is up to 8.77e-4 from it on 80 mel bins; from 4096 rows on
    it sums each product in ascending order, as the kernels do)."""
    state = make_frontend_state(cfg, device=dev)
    B, L = audio.shape
    args = (state, cfg.frame_length, cfg.frame_shift, cfg.n_fft)
    kernel, plain = ((cuda_frontend.log_mel_unfused_cuda, cuda_frontend.log_mel_unfused_reference)
                     if unfused else
                     (cuda_frontend.log_mel_fused_cuda, cuda_frontend.log_mel_fused_reference))
    count = "LAUNCHES_UNFUSED" if unfused else "LAUNCHES"
    before = getattr(cuda_frontend, count)
    got = kernel(audio, *args, precision=precision, want_energy=want_energy)
    torch.cuda.synchronize()
    assert getattr(cuda_frontend, count) == before + 1
    assert cuda_frontend.LAST_PLAN == _log_mel_plan(dev, B, L, cfg, precision, unfused)
    T = max(1 + (L - cfg.frame_length) // cfg.frame_shift, 1)
    reps = -(-4096 // (B * T))
    ref = plain(audio.repeat(reps, 1), *args, precision=precision, want_energy=want_energy)[:B]
    assert got.shape == ref.shape == (B, T, cfg.num_mel_bins + want_energy)
    assert torch.isfinite(got).all()
    assert float((got - ref).abs().max()) <= K1_TOL[precision]
    return got


@pytest.mark.parametrize("precision", sorted(K1_TOL))
@pytest.mark.parametrize("B", [1, 8, 64])
@pytest.mark.parametrize("chunk", [64, 32])
def test_log_mel_unfused_kernel_at_streaming_chunks(dev, chunk, B, precision):
    """K7 at the streaming recipe's 80 mel bins on chunks of 64 and 32
    frames (240 + chunk * 160 samples) for 1, 8 and 64 streams; a stream's
    rows do not depend on the others in the batch."""
    cfg = FrontendConfig(num_mel_bins=80)
    L = 240 + chunk * 160
    audio = torch.tensor(0.1 * np.random.RandomState(B + chunk).randn(B, L).astype(np.float32),
                         device=dev)
    got = _log_mel_held_to_plain(dev, True, audio, cfg, precision)
    alone = cuda_frontend.log_mel_unfused_cuda(audio[-1:], make_frontend_state(cfg, device=dev),
                                               400, 160, 512, precision=precision)
    assert torch.equal(alone[0], got[-1])


@pytest.mark.parametrize("precision", sorted(K1_TOL))
@pytest.mark.parametrize("B,L", [(1, 16000), (65536, 400), (65536, 561)])
def test_log_mel_kernel_batch_edges(dev, B, L, precision):
    """K1 on one utterance of 98 frames (not a multiple of any frame tile)
    and on 65,536 rows of one and two frames (past the 65,535 CTAs a grid's
    second dimension holds)."""
    audio = torch.tensor(0.1 * np.random.RandomState(L).randn(B, L).astype(np.float32),
                         device=dev)
    _log_mel_held_to_plain(dev, False, audio, FrontendConfig(num_mel_bins=80), precision)


@pytest.mark.parametrize("want_energy", [False, True])
@pytest.mark.parametrize("precision", sorted(K1_TOL))
@pytest.mark.parametrize("unfused", [False, True], ids=["k1", "k7"])
def test_log_mel_kernels_at_nfft_1024(dev, unfused, precision, want_energy):
    """50 ms frames (FL = 800) and n_fft 1024, which the kernels once
    refused: two passes of 256 bins and the Nyquist bin, and mel filters
    whose runs cross the passes' boundary at bin 256."""
    cfg = FrontendConfig(num_mel_bins=80, frame_length_ms=50.0, n_fft=1024)
    runs = make_frontend_state(cfg, device=dev).mel_runs.cpu()
    assert bool(((runs[0] < 256) & (runs[1] > 256)).any())
    audio = torch.tensor(0.1 * np.random.RandomState(3).randn(3, 5000).astype(np.float32),
                         device=dev)
    _log_mel_held_to_plain(dev, unfused, audio, cfg, precision, want_energy)
    assert cuda_frontend.LAST_PLAN["passes"] == 2


def test_log_mel_kernel_refuses_past_shared_memory(dev):
    cfg = FrontendConfig(num_mel_bins=80, frame_length_ms=200.0, n_fft=8192)
    audio = torch.zeros(1, 8000, device=dev)
    before = cuda_frontend.LAUNCHES
    with pytest.raises(ValueError, match="shared memory"):
        cuda_frontend.log_mel_fused_cuda(audio, make_frontend_state(cfg, device=dev), 3200, 160,
                                         8192)
    assert cuda_frontend.LAUNCHES == before


# one row, batch rows over several splits (B = 300), small batches at the
# recipe's H = 512 (B = 1, 4, 7: once refused), and wh streamed through the
# ring where it does not fit shared memory (H = 1536, 2304: once refused)
BIGRU_CASES = [(9, 1, 8), (7, 5, 24), (6, 300, 16), (11, 40, 64), (5, 1, 512), (4, 4, 512),
               (3, 7, 512), (3, 4, 1536), (2, 3, 2304)]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("T,B,H", BIGRU_CASES)
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
    before = cuda_gru.LAUNCHES
    got = cuda_gru.bigru_scan_cuda(*args)
    ref = cuda_gru.bigru_scan_reference(*args)
    torch.cuda.synchronize()
    assert cuda_gru.LAUNCHES == before + 1
    assert cuda_gru.LAST_BIGRU_WH == ("streamed" if H >= 1536 else "resident")
    assert got.dtype == dtype and got.shape == (T, B, 2 * H)
    assert float((got.float() - ref.float()).abs().max()) <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,B,H", [(9, 1, 8), (11, 40, 64), (3, 7, 512), (3, 4, 1536)])
def test_bigru_kernel_is_the_grouped_kernel_reversed(dev, T, B, H, dtype):
    """K2 is K5's kernel with two groups, group 1's frames reversed by
    addressing: its output is bit-equal to K5's on the stacked inputs in
    kernel time (p1 flipped), group 1 flipped back, with the same plan."""
    arrays, tmask, _ = _gru_problem(dev, T, B, H, T * B + H)
    p0, p1, wh, bh = (x.to(dtype).contiguous() for x in arrays)
    got = cuda_gru.bigru_scan_cuda(p0, p1, wh, bh, tmask)
    plan = cuda_gru.LAST_BIGRU_PLAN, cuda_gru.LAST_BIGRU_WH
    ys = cuda_gru.gru_scan_cuda(torch.stack([p0, p1.flip(0)], 1).contiguous(), wh, bh, tmask)
    torch.cuda.synchronize()
    assert (cuda_gru.LAST_GRU_PLAN, cuda_gru.LAST_GRU_WH) == plan
    assert torch.equal(got, torch.cat([ys[:, 0], ys[:, 1].flip(0)], -1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,B,H", [(11, 40, 64), (3, 4, 1536)])
def test_bigru_kernel_is_deterministic(dev, T, B, H, dtype):
    """Two K2 launches on the same inputs give bit-identical states: the
    warps' partial products are added in a fixed order, with no atomics
    (resident and streamed wh)."""
    arrays, tmask, _ = _gru_problem(dev, T, B, H, T * B + H)
    args = tuple(x.to(dtype).contiguous() for x in arrays) + (tmask,)
    assert torch.equal(cuda_gru.bigru_scan_cuda(*args), cuda_gru.bigru_scan_cuda(*args))


@pytest.mark.parametrize("H", [12, 16])
def test_bigru_kernel_rejects_bad_input(dev, H):
    """H = 12 is not a multiple of 8; at H = 16 wh is not contiguous. Both:
    CPU tensors, and an H whose two directions' grids exceed the SMs."""
    x = torch.zeros(4, 2, 3 * H, device=dev)
    wh = torch.zeros(2, 3 * H, H, device=dev).transpose(1, 2)
    if H % 8:
        wh = wh.contiguous()
    bh, tm = torch.zeros(2, 3 * H, device=dev), torch.ones(4, 2, 2, device=dev)
    with pytest.raises(ValueError, match="multiple of 8" if H % 8 else "contiguous"):
        cuda_gru.bigru_scan_cuda(x, x, wh, bh, tm)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_gru.bigru_scan_cuda(x.cpu(), x.cpu(), wh.contiguous().cpu(), bh.cpu(), tm.cpu())
    # the H bound: 2 ceil(H / 64) CTAs, one per SM (H > 4224 on 132 SMs)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    Hb = 64 * (sms // 2) + 8
    big = [torch.zeros(s, dtype=torch.bfloat16, device=dev)
           for s in ((1, 1, 3 * Hb), (2, Hb, 3 * Hb), (2, 3 * Hb))]
    with pytest.raises(ValueError, match="ceil"):
        cuda_gru.bigru_scan_cuda(big[0], big[0], big[1], big[2], tm[:1, :, :1])


# small vocabularies (a one-warp CTA) with every LM order; V = 300 and
# W * V just past 2048 (eight warps); V = 4233, the AISHELL character
# recipes, where the first version of the kernel asked for more shared
# memory than a block may have (a trigram table there would not fit)
BEAM_SMALL = ((1, 5, 0), (3, 40, 2), (32, 7, 0), (8, 12, 11), (16, 300, 0), (32, 65, 3))
BEAM_CASES = ([(W, V, blank, lm) for W, V, blank in BEAM_SMALL for lm in (0, 2, 3)]
              + [(W, 4233, 0, lm) for W in (8, 16, 32) for lm in (0, 2)])


@pytest.mark.parametrize("W,V,blank,lm_order", BEAM_CASES)
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
    _assert_beam_equal(got, ref, blank)


def _assert_beam_equal(got, ref, blank):
    """Backpointers and the carried state bit-equal, and the tracebacks."""
    for a, b in zip(got[:2], ref[:2]):
        assert torch.equal(a, b)
    for name, a, b in zip(got[2]._fields, got[2], ref[2]):
        assert torch.equal(a, b), name
    ids, n, score = cuda_beam.beam_traceback(*got[:2], got[2].p_b, got[2].p_nb, blank)
    r_ids, r_n, r_score = cuda_beam.beam_traceback(*ref[:2], ref[2].p_b, ref[2].p_nb, blank)
    assert torch.equal(ids, r_ids) and torch.equal(n, r_n)
    assert float((score - r_score).abs().max()) <= 1e-4


@pytest.mark.parametrize("lm_order,V", [(0, 50), (3, 50), (2, 4233)],
                         ids=["0", "3", "2-V4233"])
def test_beam_kernel_carried_chunks_equal_one_pass(dev, lm_order, V):
    """K4 fed chunks of one log-prob sequence, each from the state the
    previous one left, gives one pass's backpointers and state; at V = 4233
    with a bigram table, the streaming LM decode's shape."""
    rng = np.random.RandomState(11)
    B, T, W = 4, 40, 8
    logp = torch.log_softmax(torch.tensor(rng.randn(B, T, V) * 3.0, dtype=torch.float32,
                                          device=dev), -1).contiguous()
    lengths = torch.tensor([T, 33, 16, 0], device=dev)
    lm = None
    if lm_order:
        lm = torch.tensor(np.log(rng.dirichlet(np.ones(V), (V + 1) ** (lm_order - 1))),
                          dtype=torch.float32, device=dev)
    kw = dict(lm_table=lm, lm_order=lm_order, lm_weight=0.5, lm_bonus=0.3)
    p1, c1, s1 = cuda_beam.ctc_beam_cuda(logp, lengths, W, 0, **kw)
    state, ps, cs = None, [], []
    for a, b in ((0, 16), (16, 17), (17, 40)):
        p, c, state = cuda_beam.ctc_beam_cuda(logp[:, a:b].contiguous(),
                                              torch.clamp(lengths - a, min=0), W, 0,
                                              state=state, **kw)
        ps.append(p)
        cs.append(c)
    assert torch.equal(torch.cat(ps), p1) and torch.equal(torch.cat(cs), c1)
    for name, a, b in zip(s1._fields, s1, state):
        assert torch.equal(a, b), name
    _assert_beam_equal((p1, c1, s1), cuda_beam.ctc_beam_reference(logp, lengths, W, 0, **kw), 0)


def test_beam_kernel_rejects_beyond_limits(dev):
    logp = torch.zeros(1, 2, 5, device=dev)
    before = cuda_beam.LAUNCHES
    with pytest.raises(ValueError, match="beam_width"):
        cuda_beam.ctc_beam_cuda(logp, torch.tensor([2], device=dev), 33)
    with pytest.raises(ValueError, match="vocabulary"):
        cuda_beam.ctc_beam_cuda(torch.zeros(1, 2, cuda_beam.MAX_VOCAB + 1, device=dev),
                                torch.tensor([2], device=dev), 8)
    with pytest.raises(ValueError, match="blank_id"):
        cuda_beam.ctc_beam_cuda(logp, torch.tensor([2], device=dev), 4, 5)
    assert cuda_beam.LAUNCHES == before


def _beam_problem(dev, seed, B, T, V, lengths, lm_order=0):
    rng = np.random.RandomState(seed)
    logp = torch.log_softmax(torch.tensor(rng.randn(B, T, V) * 4.0, dtype=torch.float32,
                                          device=dev), -1).contiguous()
    lm = None
    if lm_order:
        lm = torch.tensor(np.log(rng.dirichlet(np.ones(V), (V + 1) ** (lm_order - 1))),
                          dtype=torch.float32, device=dev)
    return logp, torch.tensor(lengths, device=dev), lm


def _beam_launch_checked(dev, args, state=None, plan=None):
    """One K4 launch against the plain version: bit-equal, one launch
    counted, and the launch plan when given."""
    before = cuda_beam.LAUNCHES
    got = cuda_beam.ctc_beam_cuda(*args, state=state)
    ref = cuda_beam.ctc_beam_reference(*args, state=state)
    torch.cuda.synchronize()
    assert cuda_beam.LAUNCHES == before + 1
    if plan is not None:
        assert cuda_beam.LAST_BEAM_PLAN == plan
    _assert_beam_equal(got, ref, args[3])
    return got


@pytest.mark.parametrize("lm_order", [0, 2, 3])
def test_beam_kernel_decode_shape(dev, lm_order):
    """The beam-16 decode of librispeech_ctc_bigru: T = 400, B = 32, V = 32,
    lengths 1 to T, four warps per utterance."""
    T, B = 400, 32
    lengths = np.random.RandomState(5).randint(1, T + 1, B)
    lengths[0], lengths[1] = T, 1
    logp, lens, lm = _beam_problem(dev, 7 + lm_order, B, T, 32, lengths, lm_order)
    _beam_launch_checked(dev, (logp, lens, 16, 0, lm, lm_order, 0.5, 0.3), plan=(4, 1))


def test_beam_kernel_streaming_chunk_shape(dev):
    """One aishell_streaming chunk: T = 32, B = 64, W = 8, V = 4233 from the
    state a first chunk left, a cluster of two CTAs per utterance."""
    T, B, V, W = 32, 64, 4233, 8
    lengths = np.random.RandomState(6).randint(0, T + 1, B)
    lengths[0], lengths[1] = T, 0
    first, _, _ = _beam_problem(dev, 8, B, T, V, [T] * B)
    logp, lens, _ = _beam_problem(dev, 9, B, T, V, lengths)
    state = cuda_beam.ctc_beam_reference(first, torch.full((B,), T, device=dev), W)[2]
    _beam_launch_checked(dev, (logp, lens, W, 0), state=state, plan=(8, 2))


# W = 8 puts the cluster threshold (W * V = 8192) between V = 1023 and 1024
@pytest.mark.parametrize("V,plan", [(1023, (8, 1)), (1024, (8, 2))])
@pytest.mark.parametrize("B", [1, 3])
def test_beam_kernel_cluster_threshold(dev, B, V, plan):
    lengths = [19, 0, 7][:B]
    logp, lens, _ = _beam_problem(dev, V + B, B, 19, V, lengths)
    _beam_launch_checked(dev, (logp, lens, 8, 0), plan=plan)
    # and from a carried state
    state = cuda_beam.ctc_beam_reference(logp, torch.full((B,), 19, device=dev), 8)[2]
    _beam_launch_checked(dev, (logp, lens, 8, 0), state=state, plan=plan)


def test_beam_kernel_at_its_limits(dev):
    """W = 32 over the largest vocabulary, 16384 symbols."""
    logp, lens, _ = _beam_problem(dev, 3, 2, 6, cuda_beam.MAX_VOCAB, [6, 4])
    _beam_launch_checked(dev, (logp, lens, 32, 0), plan=(8, 2))


def test_beam_kernel_fewer_live_candidates_than_beams(dev):
    """W = 16 over V = 2 with blank 1: one live extend a beam, so the
    rounds' re-pick of a taken column decides most of the beams."""
    logp, lens, _ = _beam_problem(dev, 4, 3, 12, 2, [12, 5, 1])
    _beam_launch_checked(dev, (logp, lens, 16, 1), plan=(4, 1))


@pytest.mark.parametrize("V", [32, 4233])
def test_beam_kernel_all_lengths_zero(dev, V):
    """Every utterance finished: identity backpointers, the state as given."""
    logp, lens, _ = _beam_problem(dev, 2, 3, 5, V, [0, 0, 0])
    state = cuda_beam.ctc_beam_reference(logp, torch.full((3,), 5, device=dev), 8)[2]
    p, c, out = _beam_launch_checked(dev, (logp, lens, 8, 0), state=state)
    assert torch.equal(p, torch.arange(8, device=dev).expand(5, 3, 8).to(torch.int32))
    assert bool((c == -1).all())
    for name, a, b in zip(out._fields, out, state):
        assert torch.equal(a, b.to(a.dtype)), name


@pytest.mark.parametrize("W,V", [(16, 32), (8, 4233)])
def test_beam_kernel_deterministic(dev, W, V):
    logp, lens, _ = _beam_problem(dev, 12, 5, 30, V, [30, 29, 11, 1, 0])
    a = cuda_beam.ctc_beam_cuda(logp, lens, W)
    b = cuda_beam.ctc_beam_cuda(logp, lens, W)
    for x, y in zip((*a[:2], *a[2]), (*b[:2], *b[2])):
        assert torch.equal(x, y)


@pytest.mark.parametrize("W,V,lm_order", [(16, 32, 3), (8, 4233, 0), (16, 300, 2)])
def test_beam_phases_build_matches_kernel(dev, W, V, lm_order):
    """The stamped build gives ctc_beam_cuda's backpointers and state, and a
    non-negative cycle count per phase of every utterance."""
    logp, lens, lm = _beam_problem(dev, 13, 4, 25, V, [25, 3, 0, 17], lm_order)
    args = (logp, lens, W, 0, lm, lm_order, 0.5, 0.3)
    want = cuda_beam.ctc_beam_cuda(*args)
    before = (cuda_beam.LAUNCHES, cuda_beam.LAUNCHES_PHASES)
    *got, phases = cuda_beam.ctc_beam_phases(*args)
    torch.cuda.synchronize()
    assert (cuda_beam.LAUNCHES, cuda_beam.LAUNCHES_PHASES) == (before[0], before[1] + 1)
    for x, y in zip((*got[:2], *got[2]), (*want[:2], *want[2])):
        assert torch.equal(x, y)
    assert phases.shape == (4, len(cuda_beam.PHASE_NAMES)) and bool((phases >= 0).all())
    assert bool((phases[0] > 0).any()) and bool((phases[2] == 0).all())


@pytest.mark.parametrize("want_energy", [False, True])
@pytest.mark.parametrize("precision", sorted(K1_TOL))
def test_log_mel_unfused_kernel_matches_plain(dev, precision, want_energy):
    """K7 at the streaming chunk's shape (240 + 64 * 160 samples, 64 frames)
    and on input shorter than one frame."""
    cfg = FrontendConfig(num_mel_bins=80)
    state = make_frontend_state(cfg, device=dev)
    for L in (240 + 64 * 160, 300):
        audio = torch.tensor(np.random.RandomState(L).randn(3, L).astype(np.float32) * 0.1,
                             device=dev)
        args = (audio, state, cfg.frame_length, cfg.frame_shift, cfg.n_fft)
        before = cuda_frontend.LAUNCHES_UNFUSED
        got = cuda_frontend.log_mel_unfused_cuda(*args, precision=precision,
                                                 want_energy=want_energy)
        ref = cuda_frontend.log_mel_unfused_reference(*args, precision=precision,
                                                      want_energy=want_energy)
        torch.cuda.synchronize()
        assert cuda_frontend.LAUNCHES_UNFUSED == before + 1
        assert cuda_frontend.LAST_PLAN == _log_mel_plan(dev, 3, L, cfg, precision, True)
        assert got.shape == ref.shape == (3, max(1 + (L - 400) // 160, 1), 80 + want_energy)
        assert float((got - ref).abs().max()) <= K1_TOL[precision]


@pytest.mark.parametrize("beam", [False, True])
def test_streaming_on_card_matches_cpu(dev, beam):
    """StreamingRecognizer on CUDA (one K7 and, with beam, one K4 per step,
    no K1) against the same recognizer on the CPU, seeded cnn weights."""
    from uasr_torch.config import Config, CTCConfig
    from uasr_torch.serve import StreamingRecognizer

    cfg = Config(frontend=FrontendConfig(num_mel_bins=40, cmvn="streaming",
                                         streaming_chunk_frames=32),
                 model=ModelConfig(encoder="cnn", hidden_size=32, conv_kernel=5),
                 ctc=CTCConfig(use_beam=beam, beam_width=4), vocab_size=12)
    rng = np.random.RandomState(2)
    lens = np.array([4 * 5120, 2 * 5120 + 77])
    audio = (0.3 * rng.randn(2, 4 * 5120)).astype(np.float32)
    audio[1, lens[1]:] = 0.0
    outs = []
    for d in (dev, torch.device("cpu")):
        model = build_model(cfg.model, 12, 40, generator=torch.Generator().manual_seed(1),
                            device=d)
        rec = StreamingRecognizer(cfg, model, device=d)
        st, got = rec.init(2, lens), []
        for off in range(0, audio.shape[1], 5120):
            counts = (cuda_frontend.LAUNCHES, cuda_frontend.LAUNCHES_UNFUSED, cuda_beam.LAUNCHES)
            st, ids, n = rec.step(st, audio[:, off:off + 5120])
            got.append((ids.cpu(), n.cpu()))
            if d.type == "cuda":
                after = (cuda_frontend.LAUNCHES, cuda_frontend.LAUNCHES_UNFUSED,
                         cuda_beam.LAUNCHES)
                assert after == (counts[0], counts[1] + 1, counts[2] + int(beam))
        _, ids, n = rec.finish(st)
        got.append((ids.cpu(), n.cpu()))
        outs.append(got)
    for (a, na), (b, nb) in zip(*outs):
        assert torch.equal(a, b) and torch.equal(na, nb)


def _hmm_logits(seed, B, T, V, ties):
    """Random logits, or one-hot runs (whole rows of tied HMM paths)."""
    rng = np.random.RandomState(seed)
    if ties:
        ids = np.repeat(rng.randint(0, V, (B, T // 2 + 1)), 2, axis=1)[:, :T]
        return (10.0 * np.eye(V, dtype=np.float32)[ids]).astype(np.float32)
    return (2.0 * rng.randn(B, T, V)).astype(np.float32)


@pytest.mark.parametrize("ties", [False, True], ids=["random", "one_hot"])
@pytest.mark.parametrize("order", [2, 3], ids=["bigram", "trigram"])
def test_viterbi_on_card_equals_cpu(dev, order, ties):
    """The HMM Viterbi decode over a bigram and a trigram table on CUDA
    tensors against the same calls on the CPU: ids and lengths equal,
    scores to 1e-5 relative."""
    from uasr_torch.ops.lm import build_bigram_lm, build_trigram_lm
    from uasr_torch.ops.viterbi import make_lm_decoder

    V = 41
    rng = np.random.RandomState(order)
    seqs = [list(rng.randint(1, V, rng.randint(2, 12))) for _ in range(200)]
    table = (build_bigram_lm if order == 2 else build_trigram_lm)(seqs, V, exclude=(0,))
    logits = _hmm_logits(order + 2 * ties, 5, 60, V, ties)
    lengths = np.array([60, 37, 1, 0, 60])
    outs = []
    for d in (dev, torch.device("cpu")):
        fn = make_lm_decoder(table, 0, self_loop=0.05 if ties else 0.75, blank_prob=0.2,
                             device=d)
        outs.append([x.cpu() for x in fn(torch.tensor(logits, device=d),
                                         torch.tensor(lengths, device=d))])
    (ids, n, score), (r_ids, r_n, r_score) = outs
    assert torch.equal(ids, r_ids) and torch.equal(n, r_n)
    assert float(((score - r_score).abs() / r_score.abs().clamp_min(1e-30)).max()) <= 1e-5


@pytest.mark.parametrize("ties", [False, True], ids=["random", "one_hot"])
def test_forced_align_on_card_equals_cpu(dev, ties):
    from uasr_torch.ops.viterbi import ctc_forced_align

    V, T = 32, 80
    logits = _hmm_logits(5 + ties, 4, T, V, ties)
    rng = np.random.RandomState(6)
    labels = rng.randint(1, V, (4, 30))
    labels[0, 3] = labels[0, 2]  # a repeat: no skip between them
    llen = np.array([30, 12, 0, 30])
    lengths = np.array([T, 50, 40, 20])  # the last transcript does not fit its frames
    outs = []
    for d in (dev, torch.device("cpu")):
        outs.append([x.cpu() for x in ctc_forced_align(
            *(torch.tensor(x, device=d) for x in (logits, lengths, labels, llen)))])
    (ids, score), (r_ids, r_score) = outs
    assert torch.equal(ids, r_ids)
    assert float(((score - r_score).abs() / r_score.abs().clamp_min(1e-30)).max()) <= 1e-5


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


def _gru_problem(dev, T, B, H, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    lengths = torch.randint(1, T + 1, (B,), device=dev, generator=gen)
    lengths[0] = T
    tpos = torch.arange(T, device=dev)[:, None]
    tmask = torch.stack([tpos < lengths[None], tpos >= (T - lengths)[None]], 1)
    p0, p1 = (0.5 * torch.randn(T, B, 3 * H, device=dev, generator=gen) for _ in range(2))
    wh = torch.randn(2, H, 3 * H, device=dev, generator=gen) / H ** 0.5
    bh = 0.1 * torch.randn(2, 3 * H, device=dev, generator=gen)
    dout = torch.randn(T, B, 2 * H, device=dev, generator=gen)
    return (p0, p1, wh, bh), tmask, dout


# T = 1, one row, batch rows over several splits (B = 300), and wh streamed
# through the chain's ring where no resident plan fits (H = 1536, 2304).
BIGRU_BWD_CASES = [(1, 3, 8), (9, 1, 8), (7, 5, 24), (6, 300, 16), (11, 40, 64), (3, 4, 1536),
                   (2, 3, 2304)]


def _bigru_bwd_problem(dev, T, B, H, dtype):
    arrays, tmask, dout = _gru_problem(dev, T, B, H, T * B + H)
    args = tuple(x.to(dtype).contiguous() for x in arrays) + (tmask,)
    return args, cuda_gru.bigru_scan_cuda(*args), dout.to(dtype)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2 ** -7)])
@pytest.mark.parametrize("T,B,H", BIGRU_BWD_CASES)
def test_bigru_bwd_kernel_matches_plain(dev, T, B, H, dtype, tol):
    """K2-bwd (its coefficient kernel, then the reverse chain) against its
    plain version; tolerance relative to the largest reference value (bf16:
    one bf16 ulp, for a product that another summation order rounds the
    other way); wh resident in shared memory, or streamed where it does not
    fit."""
    args, out, dout = _bigru_bwd_problem(dev, T, B, H, dtype)
    before = (cuda_gru.LAUNCHES_BWD, cuda_gru.LAUNCHES_BWD_COEFFS)
    got = cuda_gru.bigru_scan_bwd_cuda(*args, out, dout)
    wh_mode = cuda_gru.LAST_BIGRU_BWD_WH
    ref = cuda_gru.bigru_scan_bwd_reference(*args, out, dout)
    torch.cuda.synchronize()
    assert (cuda_gru.LAUNCHES_BWD, cuda_gru.LAUNCHES_BWD_COEFFS) == (before[0] + 1,
                                                                     before[1] + 1)
    assert wh_mode == ("streamed" if H >= 1536 else "resident")
    scale = max(float(r.float().abs().max()) for r in ref)
    for a, r in zip(got, ref):
        assert a.dtype == dtype and a.shape == r.shape
        assert float((a.float() - r.float()).abs().max()) <= tol * scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,B,H", BIGRU_BWD_CASES)
def test_bigru_bwd_coeffs_kernel_matches_plain(dev, T, B, H, dtype):
    """K2-bwd's coefficient kernel alone (K2's tensors read in place, group
    1 in reversed frames) against its plain version on the same out: f32
    1e-5, bf16 one bf16 ulp (2^-7) of the largest; a masked row-step gets
    c4 = 0 and ch = 1."""
    args, out, _ = _bigru_bwd_problem(dev, T, B, H, dtype)
    c4, ch = cuda_gru.bigru_bwd_coeffs_cuda(*args, out)
    r_c4, r_ch = cuda_gru.bigru_bwd_coeffs_reference(*args, out)
    torch.cuda.synchronize()
    for got, ref in ((c4, r_c4), (ch, r_ch)):
        assert got.dtype == torch.float32 and got.shape == ref.shape == (T, 2, B, got.shape[-1])
        tol = 1e-5 if dtype == torch.float32 else 2 ** -7 * float(ref.abs().max())
        assert float((got - ref).abs().max()) <= tol
    off = ~args[-1]  # [T, 2, B]
    assert not c4[off].any()
    assert bool((ch[off] == 1).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,B,H", [(11, 40, 64), (3, 4, 1536)])
def test_bigru_bwd_kernel_is_deterministic(dev, T, B, H, dtype):
    """Two K2-bwd launches on the same inputs give bit-identical gradients:
    the warps' partial products are added in a fixed order, with no
    atomics (resident and streamed wh)."""
    args, out, dout = _bigru_bwd_problem(dev, T, B, H, dtype)
    first = cuda_gru.bigru_scan_bwd_cuda(*args, out, dout)
    second = cuda_gru.bigru_scan_bwd_cuda(*args, out, dout)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_bigru_autograd_on_card_matches_cpu(dev):
    """Gradients through BiGRUScan (K2 + K2-bwd) against the same function
    on CPU tensors (plain versions), f32."""
    arrays, tmask, dout = _gru_problem(dev, 13, 6, 32, 5)
    grads = []
    for d in (dev, torch.device("cpu")):
        leaves = [x.detach().to(d).requires_grad_() for x in arrays]
        out = cuda_gru.bigru_scan(*leaves, tmask.to(d))
        (out * dout.to(d)).sum().backward()
        grads.append([x.grad.cpu() for x in leaves])
    for a, b in zip(*grads):
        assert float((a - b).abs().max()) <= 1e-4 * max(1.0, float(b.abs().max()))


def test_bigru_bwd_kernel_rejects_bad_input(dev):
    arrays, tmask, dout = _gru_problem(dev, 4, 2, 16, 0)
    args = tuple(x.contiguous() for x in arrays) + (tmask,)
    out = cuda_gru.bigru_scan_cuda(*args)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_gru.bigru_scan_bwd_cuda(*args, out, dout.transpose(0, 1).contiguous().transpose(0, 1))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        cuda_gru.bigru_scan_bwd_cuda(*(x.half() for x in arrays), tmask, out.half(), dout.half())
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_gru.bigru_scan_bwd_cuda(*(x.cpu() for x in args), out.cpu(), dout.cpu())
    # the H bound: 2 ceil(H / 64) CTAs, one per SM (H > 4224 on 132 SMs)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    H = 64 * (sms // 2) + 8
    big = [torch.zeros(s, dtype=torch.bfloat16, device=dev)
           for s in ((1, 1, 3 * H), (2, H, 3 * H), (2, 3 * H), (1, 1, 2 * H))]
    with pytest.raises(ValueError, match="ceil"):
        cuda_gru.bigru_scan_bwd_cuda(big[0], big[0], big[1], big[2], tmask[:1, :, :1], big[3],
                                     big[3])


def _ctc_problem(dev, B, T, U, V, blank, seed):
    rng = np.random.RandomState(seed)
    llen = rng.randint(1, T + 1, B)
    llen[0] = T
    if B > 2:
        llen[2] = 0  # batch padding row
    ulen = np.minimum(rng.randint(0, U + 1, B), llen // 2)
    ulen[0] = min(U, T // 2)
    nonblank = np.array([v for v in range(V) if v != blank])
    labels = nonblank[rng.randint(0, V - 1, (B, U))]
    labels[np.arange(U)[None] >= ulen[:, None]] = 0
    logits = torch.tensor(rng.randn(B, T, V) * 3.0, dtype=torch.float32, device=dev)
    return logits, *(torch.tensor(a, device=dev) for a in (llen, labels, ulen))


def _ctc_holes(llen, ulen, labels, T, seed):
    """An act mask that is not a prefix: frames dropped inside each row and
    row 1 starting inactive; label lengths cut so that every row stays
    feasible (2 U + 1 <= its active frames)."""
    rng = np.random.RandomState(seed)
    lens = llen.cpu().numpy()
    act = (np.arange(T)[:, None] < lens[None, :]) & (rng.rand(T, len(lens)) > 0.15)
    if len(lens) > 1:
        act[:3, 1] = False
    n = act.sum(0)
    u = np.minimum(ulen.cpu().numpy(), np.maximum(n - 1, 0) // 2)
    lab = labels.cpu().numpy().copy()
    lab[np.arange(lab.shape[1])[None] >= u[:, None]] = 0
    dev = llen.device
    return (torch.tensor(act, dtype=torch.float32, device=dev), torch.tensor(u, device=dev),
            torch.tensor(lab, device=dev))


# T = 1, T below the ring depth and not a multiple of it, T = 1000; B = 1 and
# more CTAs than SMs; S = 1 and S = 8191 (8 states a thread, the ring cut to
# fit shared memory); every ring depth; act masks with holes
@pytest.mark.parametrize("T,U,V,blank,B,holes,depth", [
    (1, 0, 5, 0, 4, False, 8), (7, 2, 6, 3, 4, False, 8), (40, 12, 30, 0, 4, False, 8),
    (50, 600, 9, 1, 4, False, 8), (30, 2000, 40, 5, 4, False, 8),
    (37, 12, 30, 0, 4, True, 2), (37, 12, 30, 0, 4, True, 4), (37, 12, 30, 0, 4, True, 8),
    (37, 12, 30, 0, 4, True, 16), (5, 3, 7, 0, 1, False, 16), (1000, 40, 12, 0, 4, True, 8),
    (60, 20, 12, 2, 160, True, 8), (20, 0, 5, 0, 4, True, 8), (30, 4095, 40, 5, 3, True, 8)])
def test_ctc_kernels_match_plain(dev, T, U, V, blank, B, holes, depth):
    """K3 and K3-bwd against their plain versions: S from 1 to 8191 (more
    states than threads), a non-zero blank, a zero-length row, T and B
    around the ring's depth and the SM count, act masks that are not a
    prefix."""
    logits, llen, labels, ulen = _ctc_problem(dev, B, T, U, V, blank, T + U + B)
    if holes:
        act, ulen, labels = _ctc_holes(llen, ulen, labels, T, T + B)
    emit, act0, skip, svalid, finals = cuda_ctc.ctc_inputs(logits, llen, labels, ulen, blank)
    act = act if holes else act0
    traj = cuda_ctc.ctc_alpha_cuda(emit, act, skip, svalid, depth=depth)
    ref = cuda_ctc.ctc_alpha_reference(emit, act, skip, svalid)
    ll = cuda_ctc.final_ll(ref[-1], finals)
    g = torch.tensor(np.random.RandomState(B).uniform(-2, 2, B), dtype=torch.float32,
                     device=dev)
    demit = cuda_ctc.ctc_beta_cuda(emit, act, skip, finals, ref, ll, g, depth=depth)
    demit_ref = cuda_ctc.ctc_beta_reference(emit, act, skip, finals, ref, ll, g)
    torch.cuda.synchronize()
    assert float(((traj - ref).abs() / (1 + ref.abs())).max()) <= 1e-6
    assert float((cuda_ctc.final_ll(traj[-1], finals) - ll).abs().max()) <= 1e-3
    assert float((demit - demit_ref).abs().max()) <= 1e-5
    assert not demit[act == 0].any()
    if B > 2:
        assert not demit[:, 2].any()
    # the plan: states per thread the least power of two that fits 1024
    # threads; the ring halved from the depth asked while it does not fit
    S = 2 * U + 1
    k = 1
    while k * 1024 < S:
        k *= 2
    optin = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    for plan, rows in ((cuda_ctc.LAST_ALPHA_PLAN, 1), (cuda_ctc.LAST_BETA_PLAN, 2)):
        d = depth
        while d > 2 and 4 * ((2 + rows * d) * S + d) > optin:
            d //= 2
        assert plan == ((-(-S // k) + 31) // 32 * 32, d)


@pytest.mark.parametrize("T,U,B", [(37, 12, 4), (400, 256, 6)])
def test_ctc_phases_build_matches_kernel(dev, T, U, B):
    """The stamped builds give ctc_alpha_cuda's and ctc_beta_cuda's outputs
    bit for bit, and a non-negative cycle count per phase of every CTA."""
    logits, llen, labels, ulen = _ctc_problem(dev, B, T, U, 30, 0, T + U)
    act, ulen, labels = _ctc_holes(llen, ulen, labels, T, T)
    emit, _, skip, svalid, finals = cuda_ctc.ctc_inputs(logits, llen, labels, ulen)
    traj = cuda_ctc.ctc_alpha_cuda(emit, act, skip, svalid)
    ll = cuda_ctc.final_ll(traj[-1], finals)
    g = torch.full((B,), 0.5, device=dev)
    demit = cuda_ctc.ctc_beta_cuda(emit, act, skip, finals, traj, ll, g)
    before = (cuda_ctc.LAUNCHES, cuda_ctc.LAUNCHES_BWD, cuda_ctc.LAUNCHES_PHASES)
    traj_s, pa = cuda_ctc.ctc_alpha_phases(emit, act, skip, svalid)
    demit_s, pb = cuda_ctc.ctc_beta_phases(emit, act, skip, finals, traj, ll, g)
    torch.cuda.synchronize()
    assert (cuda_ctc.LAUNCHES, cuda_ctc.LAUNCHES_BWD, cuda_ctc.LAUNCHES_PHASES) == (
        before[0], before[1], before[2] + 2)
    assert torch.equal(traj_s, traj) and torch.equal(demit_s, demit)
    for p in (pa, pb):
        assert p.shape == (B, len(cuda_ctc.PHASE_NAMES)) and bool((p >= 0).all())
        assert bool((p.sum(1) > 0).all())


def test_ctc_loss_kernel_on_card_matches_cpu(dev):
    """Loss and logits gradient of ctc_loss_kernel (K3 + K3-bwd on CUDA)
    against the same function on CPU tensors and F.ctc_loss."""
    logits, llen, labels, ulen = _ctc_problem(dev, 5, 60, 20, 12, 0, 3)
    res = []
    for d in (dev, torch.device("cpu")):
        lg = logits.detach().to(d).requires_grad_()
        per = cuda_ctc.ctc_loss_kernel(lg, llen.to(d), labels.to(d), ulen.to(d))
        per.sum().backward()
        res.append((per.detach().cpu(), lg.grad.cpu()))
    (pc, gc), (pp, gp) = res
    assert float((pc - pp).abs().max()) <= 1e-4 * float(pp.abs().max())
    assert float((gc - gp).abs().max()) <= 2e-4
    ref = torch.nn.functional.ctc_loss(torch.log_softmax(logits, -1).transpose(0, 1),
                                       labels.long(), llen, ulen, reduction="none",
                                       zero_infinity=True)
    assert float((pc - ref.cpu()).abs().max()) <= 1e-3


def test_ctc_kernels_reject_bad_input(dev):
    logits, llen, labels, ulen = _ctc_problem(dev, 2, 10, 3, 5, 0, 0)
    emit, act, skip, svalid, finals = cuda_ctc.ctc_inputs(logits, llen, labels, ulen)
    with pytest.raises(ValueError, match="float32"):
        cuda_ctc.ctc_alpha_cuda(emit.double(), act, skip, svalid)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_ctc.ctc_alpha_cuda(emit, act, skip.t().contiguous().t(), svalid)
    big = torch.zeros(2, 1, 8193, device=dev)
    with pytest.raises(ValueError, match="S <= 8192"):
        cuda_ctc.ctc_alpha_cuda(big, act[:2, :1].contiguous(), big[0], big[0])
    with pytest.raises(ValueError, match="ring depth"):
        cuda_ctc.ctc_alpha_cuda(emit, act, skip, svalid, depth=3)


def test_training_step_on_card_matches_cpu(dev):
    """CTCTrainer on CUDA (K1, K2, K2-bwd, K3, K3-bwd) against the same
    trainer on the CPU (plain versions), f32, same weights and batches:
    first-step gradients per tensor, then two steps' losses and gradient
    norms. SpecAugment's draws come from a CPU generator, so its masks are
    the same on both devices."""
    import itertools

    from uasr_torch import config as tc
    from uasr_torch import train
    from uasr_torch.data.dataset import batch_iterator, make_synthetic_dataset
    from uasr_torch.frontend.specaugment import spec_augment

    examples, vocab = make_synthetic_dataset(num_utts=8, num_phones=6, seed=3)
    batches = list(itertools.islice(batch_iterator(examples, 4, 16000, 8, shuffle=False), 2))
    cfg = tc.Config(frontend=tc.FrontendConfig(num_mel_bins=16),
                    model=tc.ModelConfig(hidden_size=16, num_gru_layers=2, conv_channels=4,
                                         gru_pallas=True),
                    ctc=tc.CTCConfig(use_pallas=True),
                    train=tc.TrainConfig(lr=1e-3, lr_schedule="constant"), vocab_size=len(vocab))
    runs = []
    for d in (dev, torch.device("cpu")):
        trainer = train.CTCTrainer(cfg, device=d)
        state = trainer.init_state()
        init = {k: v.detach().clone() for k, v in state.params.items()}
        before = (cuda_gru.LAUNCHES_BWD, cuda_ctc.LAUNCHES_BWD)
        _, grads = trainer.loss_and_grads(init, batches[0], trainer.step_generator(0))
        if d.type == "cuda":
            assert (cuda_gru.LAUNCHES_BWD, cuda_ctc.LAUNCHES_BWD) == (before[0] + 2,
                                                                      before[1] + 1)
        steps = []
        for b in batches:
            state, aux = trainer.train_step(state, b)
            steps.append((float(aux["loss"]), float(aux["grad_norm"])))
        runs.append(({k: g.cpu() for k, g in grads.items()}, steps))
    (g_card, s_card), (g_cpu, s_cpu) = runs
    for k, g in g_cpu.items():
        assert float((g_card[k] - g).norm() / g.norm().clamp_min(1e-30)) <= 1e-4, k
    for (loss_c, norm_c), (loss_p, norm_p) in zip(s_card, s_cpu):
        assert abs(loss_c - loss_p) <= 1e-4 * abs(loss_p)
        assert abs(norm_c - norm_p) <= 1e-3 * norm_p
    fcfg = tc.FrontendConfig(specaug_freq_mask=5, specaug_freq_masks=2, specaug_time_mask=7,
                             specaug_time_masks=2)
    feat, flen = torch.randn(3, 40, 16), torch.tensor([40, 22, 9])
    masked = [spec_augment(torch.Generator().manual_seed(5), feat.to(d), flen.to(d), fcfg).cpu()
              for d in (dev, torch.device("cpu"))]
    assert torch.equal(*masked)


# ---------------------------------------------------------------- K5, K6


def _gru_group_problem(dev, T, G, B, H, seed, dead=0):
    """Inputs of K5 with mixed lengths per group, incl. a row of length 0;
    the last `dead` rows of every group have length 0."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    lengths = torch.randint(0, T + 1, (G, B), device=dev, generator=gen)
    lengths[0, 0] = T
    if B > 1:
        lengths[-1, 1] = 0
    if dead:
        lengths[:, B - dead:] = 0
    tmask = torch.arange(T, device=dev)[:, None, None] < lengths[None]  # [T, G, B]
    xp = 0.5 * torch.randn(T, G, B, 3 * H, device=dev, generator=gen)
    wh = torch.randn(G, H, 3 * H, device=dev, generator=gen) / H ** 0.5
    bh = 0.1 * torch.randn(G, 3 * H, device=dev, generator=gen)
    return (xp, wh, bh), tmask, lengths


# T = 1; B = 1; one group and two; the lc_bigru backward windows folded
# into the batch (B = 1216, T = 24, H = 384) and one streaming step's
# (B = 64); rows split over several tiles and batch splits; zero-length
# trailing rows (GRU_DEAD_ROWS), so whole passes and, in f32, a 32-row
# warp tile beside a live one (rows 472-503 of the split at 440) skip their
# products; wh streamed past what shared memory holds (H = 1536, G = 3
# and H = 2304, beyond the old bounds in f32 and bf16)
GRU_CASES = [(1, 1, 1, 8), (1, 2, 3, 16), (9, 1, 1, 384), (7, 2, 5, 24), (24, 1, 1216, 384),
             (24, 1, 64, 384), (6, 2, 300, 64), (13, 1, 40, 512), (6, 1, 1200, 384),
             (3, 2, 20, 1536), (2, 1, 9, 2304)]
GRU_DEAD_ROWS = {(6, 1, 1200, 384): 728}


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("T,G,B,H", GRU_CASES)
def test_gru_kernel_matches_plain(dev, T, G, B, H, dtype, tol):
    args, tmask, lengths = _gru_group_problem(dev, T, G, B, H, T * B + H + G,
                                              GRU_DEAD_ROWS.get((T, G, B, H), 0))
    args = tuple(x.to(dtype).contiguous() for x in args)
    before = cuda_gru.LAUNCHES_GRU
    got = cuda_gru.gru_scan_cuda(*args, tmask)
    ref = cuda_gru.gru_scan_reference(*args, tmask)
    torch.cuda.synchronize()
    assert cuda_gru.LAUNCHES_GRU == before + 1
    assert cuda_gru.LAST_GRU_WH == ("streamed" if H >= 1536 else "resident")
    assert got.dtype == dtype and got.shape == (T, G, B, H)
    assert float((got.float() - ref.float()).abs().max()) <= tol
    zero = lengths == 0  # [G, B]: rows that never step keep h at zero
    assert not got.permute(1, 2, 0, 3)[zero].any()


def test_gru_kernel_rejects_bad_input(dev):
    x = torch.zeros(4, 1, 2, 36, device=dev)
    bh, tm = torch.zeros(1, 36, device=dev), torch.ones(4, 1, 2, device=dev)
    with pytest.raises(ValueError, match="multiple of 8"):
        cuda_gru.gru_scan_cuda(x, torch.zeros(1, 12, 36, device=dev), bh, tm)
    x = torch.zeros(4, 1, 2, 48, device=dev)
    wh = torch.zeros(1, 48, 16, device=dev).transpose(1, 2)
    bh = torch.zeros(1, 48, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_gru.gru_scan_cuda(x, wh, bh, tm)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        cuda_gru.gru_scan_cuda(x.double(), wh.contiguous().double(), bh.double(), tm)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_gru.gru_scan_cuda(x.cpu(), wh.contiguous().cpu(), bh.cpu(), tm.cpu())
    G = torch.cuda.get_device_properties(dev).multi_processor_count + 1  # one CTA too many
    with pytest.raises(ValueError, match="ceil"):
        cuda_gru.gru_scan_cuda(torch.zeros(4, G, 2, 48, device=dev),
                               torch.zeros(G, 16, 48, device=dev), torch.zeros(G, 48, device=dev),
                               torch.ones(4, G, 2, device=dev))
    before = cuda_gru.LAUNCHES_GRU
    cuda_gru.gru_scan(x.cpu(), wh.contiguous().cpu(), bh.cpu(), tm.cpu())
    assert cuda_gru.LAUNCHES_GRU == before  # the plain version for CPU tensors


def _attn_problem(dev, B, T, H, dh, seed, dtype):
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(B, T, H * dh, device=dev, generator=gen).to(dtype)
               for _ in range(3))
    lengths = torch.randint(1, T + 1, (B,), device=dev, generator=gen)
    lengths[0] = T
    lengths[-1] = 1  # one valid key
    kmask = (torch.arange(T, device=dev)[None, :] < lengths[:, None]).to(torch.int32)[:, None]
    bias = 0.3 * torch.randn(H, T, T, device=dev, generator=gen)
    return q, k, v, kmask, bias


# T = 8 (the padded T = 1), a ragged T padded to 40, T = 400 (the slice's
# 16 s request) with 8 heads of 64, every head size K6 takes, and lengths
# past the 552 that K6 once kept whole in shared memory: Tp = 640, 832 (33 s
# of audio) and 1024 (once refused)
ATTN_CASES = [(2, 8, 2, 16), (3, 40, 2, 32), (3, 128, 4, 64), (2, 400, 8, 64), (2, 64, 2, 128),
              (2, 640, 2, 64), (2, 832, 8, 64), (1, 1024, 1, 64)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("B,Tp,H,dh", ATTN_CASES)
def test_attention_kernel_matches_plain(dev, B, Tp, H, dh, with_bias, dtype):
    from uasr_torch.ops import cuda_attention

    q, k, v, kmask, bias = _attn_problem(dev, B, Tp, H, dh, Tp + dh, dtype)
    bias = bias if with_bias else None
    before = cuda_attention.LAUNCHES_ATTN
    out, lse = cuda_attention.mhsa_fwd_cuda(q, k, v, bias, kmask, H)
    r_out, r_lse = cuda_attention.mhsa_fwd_reference(q, k, v, bias, kmask, H)
    torch.cuda.synchronize()
    assert cuda_attention.LAUNCHES_ATTN == before + 1
    assert out.dtype == dtype and out.shape == q.shape and lse.shape == (B, H, Tp)
    # f32: summation order only; bf16: e is rounded to bf16 before the
    # product with V, and a score an ulp away may round e the other way
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    assert float((out.float() - r_out.float()).abs().max()) <= tol
    assert float((lse - r_lse).abs().max()) <= 1e-4


def test_fused_attention_pads_on_card_as_on_cpu(dev):
    """T = 1 and T = 37 through the wrapper's padding, with the
    conformer's bias and a key mask, on the card against the CPU."""
    from uasr_torch.ops import cuda_attention

    for T in (1, 37):
        q, k, v, kmask, bias = _attn_problem(dev, 3, T, 2, 16, T, torch.float32)
        args = [x.reshape(3, T, 2, 16) for x in (q, k, v)]
        mask = kmask[:, :, None, :] > 0  # [B, 1, 1, T]
        got = cuda_attention.fused_dot_product_attention(*args, bias=bias[None], mask=mask)
        ref = cuda_attention.fused_dot_product_attention(
            *(a.cpu() for a in args), bias=bias[None].cpu(), mask=mask.cpu())
        assert float((got.cpu() - ref).abs().max()) <= 1e-5


def test_attention_kernel_rejects_bad_input(dev):
    from uasr_torch.ops import cuda_attention

    q, k, v, kmask, bias = _attn_problem(dev, 2, 16, 2, 16, 0, torch.float32)
    with pytest.raises(ValueError, match="head size"):
        cuda_attention.mhsa_fwd_cuda(q, k, v, None, kmask, 4)  # dh = 8
    with pytest.raises(ValueError, match="multiple of 8"):
        cuda_attention.mhsa_fwd_cuda(q[:, :12].contiguous(), k[:, :12].contiguous(),
                                     v[:, :12].contiguous(), None, kmask[..., :12], 2)
    with pytest.raises(ValueError, match="kmask"):
        cuda_attention.mhsa_fwd_cuda(q, k, v, None, kmask.float(), 2)
    with pytest.raises(ValueError, match="bias"):
        cuda_attention.mhsa_fwd_cuda(q, k, v, bias.to(torch.bfloat16), kmask, 2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_attention.mhsa_fwd_cuda(q.cpu(), k.cpu(), v.cpu(), None, kmask.cpu(), 2)


# ------------------------------------------------------- K5-bwd, K8, K6-bwd


def _bar(ref, dtype):
    """K2-bwd's bars: f32 1e-4, bf16 one bf16 ulp (2^-7) of the largest
    reference value (a product next to a rounding boundary may round the
    other way under another summation order)."""
    return (1e-4 if dtype == torch.float32 else 2 ** -7) * max(1.0, float(ref.float().abs().max()))


# T = 1; B = 1; one group and two; the lc_bigru backward windows (B = 1216,
# T = 24, H = 384) and the 12 s forward GRU (T = 300, B = 64) come from
# chip_smoke.py; rows over several tiles and splits; length-0 rows. At the
# edges of the tensor-core tiles (128 rows x 32 units in the coefficient
# kernel, warp tiles of 16 x 16 or 32 x 32 in the chain): T B not a
# multiple of 128 (B = 1217), H not a multiple of 16 or 32 (H = 40, 24),
# G = 2 at H = 384, whole 128-row tiles masked (DEAD_ROWS), H = 1056,
# where 16 rows of wh just fit beside the chain's ring, and wh streamed
# through the ring where no resident plan fits (H = 1536 at G = 3, and
# H = 2304), in K5 and in the chain.
GRU_BWD_CASES = [(1, 1, 1, 8), (1, 2, 3, 16), (9, 1, 1, 384), (7, 2, 5, 24),
                 (24, 1, 1216, 384), (6, 2, 300, 64), (13, 1, 40, 512), (24, 1, 1217, 384),
                 (5, 2, 130, 40), (7, 2, 200, 384), (4, 1, 512, 64), (3, 1, 20, 1056),
                 (3, 2, 20, 1536), (2, 1, 9, 2304)]
DEAD_ROWS = {(4, 1, 512, 64): 256}  # zero-length rows at the end of every group


def _gru_bwd_problem(dev, T, G, B, H, dtype):
    args, tmask, lengths = _gru_group_problem(dev, T, G, B, H, T * B + H + G + 1,
                                              DEAD_ROWS.get((T, G, B, H), 0))
    return tuple(x.to(dtype).contiguous() for x in args), tmask, lengths


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,G,B,H", GRU_BWD_CASES)
def test_gru_bwd_coeffs_kernel_matches_plain(dev, T, G, B, H, dtype):
    """K5-bwd's coefficient kernel (tensor-core h_prev @ wh, then the
    gates) against its plain version on the same ys: f32 1e-5, bf16 one
    bf16 ulp (2^-7) of the largest; a masked row gets c4 = 0 and ch = 1."""
    args, tmask, lengths = _gru_bwd_problem(dev, T, G, B, H, dtype)
    ys = cuda_gru.gru_scan_cuda(*args, tmask)
    before = cuda_gru.LAUNCHES_GRU_COEFFS
    c4, ch = cuda_gru.gru_bwd_coeffs_cuda(*args, tmask, ys)
    r_c4, r_ch = cuda_gru.gru_bwd_coeffs_reference(*args, tmask, ys)
    torch.cuda.synchronize()
    assert cuda_gru.LAUNCHES_GRU_COEFFS == before + 1
    for got, ref in ((c4, r_c4), (ch, r_ch)):
        assert got.dtype == torch.float32 and got.shape == ref.shape
        tol = 1e-5 if dtype == torch.float32 else 2 ** -7 * float(ref.abs().max())
        assert float((got - ref).abs().max()) <= tol
    off = ~tmask.permute(1, 2, 0)  # [G, B, T]: masked row-steps
    assert not c4.permute(1, 2, 0, 3)[off].any()
    assert bool((ch.permute(1, 2, 0, 3)[off] == 1).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,G,B,H", GRU_BWD_CASES)
def test_gru_bwd_kernels_match_plain(dev, T, G, B, H, dtype):
    """K5's coefficient outputs, K5-bwd and K8 against their plain
    versions; a row of length 0 gets zero gradients."""
    args, tmask, lengths = _gru_bwd_problem(dev, T, G, B, H, dtype)
    dy = torch.randn(T, G, B, H, device=dev, generator=torch.Generator(device=dev).manual_seed(T))
    dy = dy.to(dtype)
    ys, c4, ch = cuda_gru.gru_scan_cuda(*args, tmask, save_coeffs=True)
    r_ys, r_c4, r_ch = cuda_gru.gru_scan_reference(*args, tmask, save_coeffs=True)
    before = (cuda_gru.LAUNCHES_GRU_BWD, cuda_gru.LAUNCHES_GRU_COEFFS, cuda_gru.LAUNCHES_GRU_LIN)
    dxp, dhn = cuda_gru.gru_scan_bwd_cuda(*args, tmask, ys, dy)
    wh_modes = [cuda_gru.LAST_GRU_BWD_WH]
    r_dxp, r_dhn = cuda_gru.gru_scan_bwd_reference(*args, tmask, ys, dy)
    out = cuda_gru.gru_scan_bwd_lin_cuda(c4, ch, dy, args[1])
    wh_modes.append(cuda_gru.LAST_GRU_BWD_WH)
    r_out = cuda_gru.gru_scan_bwd_lin_reference(c4, ch, dy, args[1])
    torch.cuda.synchronize()
    assert (cuda_gru.LAUNCHES_GRU_BWD, cuda_gru.LAUNCHES_GRU_COEFFS,
            cuda_gru.LAUNCHES_GRU_LIN) == (before[0] + 1, before[1] + 1, before[2] + 1)
    assert c4.dtype == dtype and ch.dtype == torch.float32 and out.dtype == dtype
    assert wh_modes == 2 * ["streamed" if H >= 1536 else "resident"]
    # the coefficients follow each side's own carry, which in bf16 may
    # round an ulp apart (K5's bf16 bar): one bf16 ulp of the largest
    for got, ref in ((c4, r_c4), (ch, r_ch)):
        ctol = 1e-5 if dtype == torch.float32 else 2 ** -7 * float(ref.float().abs().max())
        assert float((got.float() - ref.float()).abs().max()) <= ctol
    for got, ref in ((dxp, r_dxp), (dhn, r_dhn), (out, r_out)):
        assert got.shape == ref.shape and got.dtype == dtype
        assert float((got.float() - ref.float()).abs().max()) <= _bar(ref, dtype)
    zero = (lengths == 0)  # [G, B]
    for t in (dxp, dhn, out):
        assert not t.permute(1, 2, 0, 3)[zero].any()


@pytest.mark.parametrize("impl", ["fused", "linear"])
def test_gru_autograd_on_card_matches_cpu(dev, impl, monkeypatch):
    """Gradients through GRUScan (K5 + K5-bwd, or K5 with coefficients +
    K8) against the same function on CPU tensors (plain versions), f32."""
    monkeypatch.setattr(cuda_gru, "BWD_IMPL", impl)
    arrays, tmask, _ = _gru_group_problem(dev, 11, 2, 6, 32, 5)
    w = torch.randn(11, 2, 6, 32, device=dev, generator=torch.Generator(device=dev).manual_seed(1))
    grads = []
    for d in (dev, torch.device("cpu")):
        before = (cuda_gru.LAUNCHES_GRU_BWD, cuda_gru.LAUNCHES_GRU_LIN)
        leaves = [x.detach().to(d).requires_grad_() for x in arrays]
        (cuda_gru.gru_scan(*leaves, tmask.to(d)) * w.to(d)).sum().backward()
        launched = (cuda_gru.LAUNCHES_GRU_BWD - before[0], cuda_gru.LAUNCHES_GRU_LIN - before[1])
        want = ((0, 1) if impl == "linear" else (1, 0)) if d.type == "cuda" else (0, 0)
        assert launched == want
        grads.append([x.grad.cpu() for x in leaves])
    for a, b in zip(*grads):
        assert float((a - b).abs().max()) <= 1e-4 * max(1.0, float(b.abs().max()))


def test_gru_bwd_kernels_reject_bad_input(dev):
    args, tmask, _ = _gru_group_problem(dev, 4, 1, 2, 16, 0)
    ys = cuda_gru.gru_scan_cuda(*args, tmask)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_gru.gru_scan_bwd_cuda(*args, tmask, ys, torch.cat([ys, ys], -1)[..., :16])
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        cuda_gru.gru_scan_bwd_cuda(*(x.half() for x in args), tmask, ys.half(), ys.half())
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_gru.gru_scan_bwd_cuda(*(x.cpu() for x in args), tmask.cpu(), ys.cpu(), ys.cpu())
    _, c4, ch = cuda_gru.gru_scan_cuda(*args, tmask, save_coeffs=True)
    with pytest.raises(ValueError, match="float32"):
        cuda_gru.gru_scan_bwd_lin_cuda(c4, ch.to(torch.bfloat16), ys, args[1])
    with pytest.raises(ValueError, match="multiple of 8"):
        cuda_gru.gru_scan_bwd_lin_cuda(torch.zeros(4, 1, 2, 16, device=dev),
                                       torch.zeros(4, 1, 2, 4, device=dev),
                                       torch.zeros(4, 1, 2, 4, device=dev),
                                       torch.zeros(1, 4, 12, device=dev))


def _attn_bwd_problem(dev, B, T, H, dh, seed, dtype):
    q, k, v, kmask, bias = _attn_problem(dev, B, T, H, dh, seed, dtype)
    from uasr_torch.ops import cuda_attention

    out, lse = cuda_attention.mhsa_fwd_reference(q, k, v, bias, kmask, H)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    dout = torch.randn(B, T, H * dh, device=dev, generator=gen).to(dtype)
    return q, k, v, kmask, bias, out, lse, dout


# T = 8 (the padded T = 1); a padded T = 40; T = 400 with 8 heads of 64 (the
# slice's 16 s batch, at B = 2); Tp = 640 and 832 (33 s), past K6's old
# shared-memory limit; every head size. The last row has one valid key:
# its p is one-hot, so its t, dq and dk are rounding noise, and the full
# first row sets each tensor's scale.
ATTN_BWD_CASES = [(2, 8, 2, 16), (3, 40, 2, 32), (2, 400, 8, 64), (2, 640, 2, 64),
                  (2, 64, 2, 128), (2, 832, 8, 64)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("B,Tp,H,dh", ATTN_BWD_CASES)
def test_attention_bwd_kernel_matches_plain(dev, B, Tp, H, dh, with_bias, dtype):
    """K6-bwd against its plain version: dq, dk, dv (bf16 2e-2, f32 1e-4 of
    each tensor's largest magnitude) and d_bias (f32: 1e-4 of its largest
    magnitude; bf16 inputs: 2e-2), a row with one valid key."""
    from uasr_torch.ops import cuda_attention

    q, k, v, kmask, bias, out, lse, dout = _attn_bwd_problem(dev, B, Tp, H, dh, Tp + dh, dtype)
    bias = bias if with_bias else None
    before = cuda_attention.LAUNCHES_ATTN_BWD
    got = cuda_attention.mhsa_bwd_cuda(q, k, v, bias, kmask, out, lse, dout, H)
    ref = cuda_attention.mhsa_bwd_reference(q, k, v, bias, kmask, out, lse, dout, H)
    torch.cuda.synchronize()
    assert cuda_attention.LAUNCHES_ATTN_BWD == before + 1
    rel = 1e-4 if dtype == torch.float32 else 2e-2
    for a, r in zip(got, ref):
        if r is None:
            assert a is None
            continue
        assert a.shape == r.shape and a.dtype == r.dtype
        assert float((a.float() - r.float()).abs().max()) <= rel * float(r.float().abs().max())


def test_attention_grads_on_card_as_on_cpu(dev):
    """T = 1, T = 37 and T = 830 (padded to 832, 33 s of audio) through the
    wrapper's padding, with the conformer's bias and a key mask: the output
    and d(q, k, v, bias) on the card (K6 + K6-bwd) against the CPU (plain
    versions), f32."""
    from uasr_torch.ops import cuda_attention

    for T in (1, 37, 830):
        q, k, v, kmask, bias = _attn_problem(dev, 3, T, 2, 16, T, torch.float32)
        w = torch.randn(3, T, 2, 16, device=dev, generator=torch.Generator(device=dev)
                        .manual_seed(T))
        outs, grads = [], []
        for d in (dev, torch.device("cpu")):
            before = cuda_attention.LAUNCHES_ATTN_BWD
            leaves = [x.reshape(3, T, 2, 16).to(d).requires_grad_() for x in (q, k, v)]
            b = bias[None].to(d).requires_grad_()
            out = cuda_attention.fused_dot_product_attention(*leaves, bias=b,
                                                             mask=(kmask[:, :, None, :] > 0).to(d))
            (out * w.to(d)).sum().backward()
            assert cuda_attention.LAUNCHES_ATTN_BWD - before == (d.type == "cuda")
            outs.append(out.detach().cpu())
            grads.append([x.grad.cpu() for x in (*leaves, b)])
        assert float((outs[0] - outs[1]).abs().max()) <= 1e-5
        for a, r in zip(*grads):
            assert float((a - r).abs().max()) <= 1e-4 * max(1.0, float(r.abs().max()))


@pytest.mark.parametrize("B,Tp", [(2, 8), (9, 400), (32, 832)])
def test_attention_bwd_dbias_is_deterministic(dev, B, Tp):
    """Two K6-bwd launches give bit-identical d_bias: each batch group's
    partial is summed in a fixed order and the groups are added in order,
    with no atomics (one group at B = 2, several at B = 9 and 32)."""
    from uasr_torch.ops import cuda_attention

    q, k, v, kmask, bias, out, lse, dout = _attn_bwd_problem(dev, B, Tp, 2, 64, Tp + B,
                                                             torch.bfloat16)
    runs = [cuda_attention.mhsa_bwd_cuda(q, k, v, bias, kmask, out, lse, dout, 2)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0][3], runs[1][3])
    ref = cuda_attention.mhsa_bwd_reference(q, k, v, bias, kmask, out, lse, dout, 2)[3]
    assert float((runs[0][3] - ref).abs().max()) <= 2e-2 * float(ref.abs().max())


def test_attention_bwd_kernel_rejects_bad_input(dev):
    from uasr_torch.ops import cuda_attention

    q, k, v, kmask, bias, out, lse, dout = _attn_bwd_problem(dev, 2, 16, 2, 16, 0, torch.float32)
    with pytest.raises(ValueError, match="lse"):
        cuda_attention.mhsa_bwd_cuda(q, k, v, None, kmask, out, lse[:, :1].contiguous(), dout, 2)
    with pytest.raises(ValueError, match="head size"):
        cuda_attention.mhsa_bwd_cuda(q, k, v, None, kmask, out, lse, dout, 4)  # dh = 8
    with pytest.raises(ValueError, match="contiguous"):
        cuda_attention.mhsa_bwd_cuda(q, k, v, None, kmask, out, lse,
                                     dout.transpose(0, 1).contiguous().transpose(0, 1), 2)
    with pytest.raises(ValueError, match="bias"):
        cuda_attention.mhsa_bwd_cuda(q, k, v, bias.to(torch.bfloat16), kmask, out, lse, dout, 2)


@pytest.mark.parametrize("encoder", ["uni_gru", "lc_bigru", "transformer", "conformer"])
def test_encoder_training_step_on_card_matches_cpu(dev, encoder):
    """CTCTrainer of each encoder on CUDA (K5 + K5-bwd, or K6 + K6-bwd)
    against the same trainer on the CPU (plain versions), f32, same weights
    and batch: first-step loss and gradients per tensor (a tensor whose
    gradient is at the rounding floor, as the key projections' bias, is
    held to 1e-2 of the global norm), then two steps' losses."""
    import itertools

    from uasr_torch import config as tc
    from uasr_torch import train
    from uasr_torch.data.dataset import batch_iterator, make_synthetic_dataset
    from uasr_torch.ops import cuda_attention

    examples, vocab = make_synthetic_dataset(num_utts=8, num_phones=6, seed=3)
    batches = list(itertools.islice(batch_iterator(examples, 4, 16000, 8, shuffle=False), 2))
    kw = dict(encoder=encoder, hidden_size=32, num_gru_layers=2, num_heads=2,
              transformer_layers=2, ffn_dim=64, conv_channels=4, gru_pallas=True,
              attn_pallas=True, lc_chunk=4, lc_lookahead=2, conformer_kernel=7,
              conformer_rel_clip=8)
    cfg = tc.Config(frontend=tc.FrontendConfig(num_mel_bins=16), model=tc.ModelConfig(**kw),
                    ctc=tc.CTCConfig(use_pallas=True),
                    train=tc.TrainConfig(lr=1e-3, lr_schedule="constant"), vocab_size=len(vocab))
    runs = []
    for d in (dev, torch.device("cpu")):
        trainer = train.CTCTrainer(cfg, device=d)
        state = trainer.init_state()
        if encoder == "conformer":
            gen = torch.Generator().manual_seed(7)
            with torch.no_grad():
                for i in range(2):
                    t = state.params[f"rel_bias{i}"]
                    t.copy_(0.3 * torch.randn(t.shape, generator=gen))
        init = {k: v.detach().clone() for k, v in state.params.items()}
        before = (cuda_gru.LAUNCHES_GRU_BWD, cuda_attention.LAUNCHES_ATTN_BWD)
        aux, grads = trainer.loss_and_grads(init, batches[0], trainer.step_generator(0))
        launched = (cuda_gru.LAUNCHES_GRU_BWD - before[0],
                    cuda_attention.LAUNCHES_ATTN_BWD - before[1])
        if d.type == "cuda":
            want = {"uni_gru": (2, 0), "lc_bigru": (4, 0)}.get(encoder, (0, 2))
            assert launched == want
        steps = []
        for b in batches:
            state, a = trainer.train_step(state, b)
            steps.append(float(a["loss"]))
        runs.append((float(aux["loss"]), {k: g.cpu() for k, g in grads.items()}, steps))
    (l_card, g_card, s_card), (l_cpu, g_cpu, s_cpu) = runs
    assert abs(l_card - l_cpu) <= 1e-5 * abs(l_cpu)
    total = float(cuda_adam.sq_norms_reference(g_cpu.values())[2])
    for k, g in g_cpu.items():
        assert float((g_card[k] - g).norm()) <= 1e-4 * max(float(g.norm()), 1e-2 * total), k
    for a, b in zip(s_card, s_cpu):
        assert abs(a - b) <= 1e-4 * abs(b)


def _cuda_op_cases(dev):
    """Each ``uasr::`` operator (ops/library.py) on CUDA tensors at shapes
    its kernel takes."""
    from uasr_torch.ops import library

    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=g).to(dev)  # noqa: E731
    st = make_frontend_state(FrontendConfig(num_mel_bins=40), device=dev)
    audio = r(2, 4000) * 0.1
    T, B, H = 5, 8, 64
    wh, bh = r(2, H, 3 * H) * 0.1, r(2, 3 * H)
    tm = torch.ones(T, 2, B, dtype=torch.bool, device=dev)
    q, k, v = (r(2, 16, 64) for _ in range(3))
    km = torch.ones(2, 1, 16, dtype=torch.int32, device=dev)
    lp = torch.log_softmax(r(2, 6, 32), -1).contiguous()
    s = cuda_beam.beam_init(2, 4, dev)
    return {
        "log_mel_fused": (library.log_mel_fused, (
            audio, st.pre_cos, st.pre_sin, st.pre_bvec, st.mel_fb, st.pre_pack, st.mel_runs,
            st.mel_w, 400, 160, 512, "highest", False)),
        "log_mel_unfused": (library.log_mel_unfused, (
            audio, st.window, st.cos_basis, st.sin_basis, st.mel_fb, st.dft_pack, st.mel_runs,
            st.mel_w, 400, 160, 512, "highest", True)),
        "bigru_scan": (library.bigru_scan, (r(T, B, 3 * H), r(T, B, 3 * H), wh, bh, tm)),
        "gru_scan": (library.gru_scan, (r(T, 1, B, 3 * H), wh[:1].contiguous(),
                                        bh[:1].contiguous(), tm[:, :1].contiguous(), False)),
        "gru_scan_coeffs": (library.gru_scan, (r(T, 1, B, 3 * H), wh[:1].contiguous(),
                                               bh[:1].contiguous(), tm[:, :1].contiguous(),
                                               True)),
        "mhsa_fwd": (library.mhsa_fwd, (q, k, v, r(2, 16, 16), km, 2)),
        "ctc_beam": (library.ctc_beam, (lp, torch.tensor([6, 3], device=dev), None, *s, 4, 0, 0,
                                        1.0, 0.0)),
        "ctc_beam_lm": (library.ctc_beam, (lp, torch.tensor([6, 3], device=dev),
                                           torch.log_softmax(r(33, 32), -1).contiguous(), *s, 4,
                                           0, 2, 0.5, 0.1)),
    }


@pytest.mark.parametrize("case", ["log_mel_fused", "log_mel_unfused", "bigru_scan", "gru_scan",
                                  "gru_scan_coeffs", "mhsa_fwd", "ctc_beam", "ctc_beam_lm"])
def test_operator_opcheck_cuda(dev, case):
    """``torch.library.opcheck`` of each operator on CUDA tensors: its
    schema, its fake implementation against the kernel's outputs, and its
    run under AOT dispatch; the CUDA implementation launches the kernel."""
    from uasr_torch.ops import cuda_attention

    op, args = _cuda_op_cases(dev)[case]
    counters = {"log_mel_fused": (cuda_frontend, "LAUNCHES"),
                "log_mel_unfused": (cuda_frontend, "LAUNCHES_UNFUSED"),
                "bigru_scan": (cuda_gru, "LAUNCHES"), "gru_scan": (cuda_gru, "LAUNCHES_GRU"),
                "mhsa_fwd": (cuda_attention, "LAUNCHES_ATTN"),
                "ctc_beam": (cuda_beam, "LAUNCHES")}
    mod, name = counters[op._name]
    before = getattr(mod, name)
    torch.library.opcheck(op, args)
    torch.cuda.synchronize()
    assert getattr(mod, name) > before


@pytest.mark.parametrize("M,K,N", [(1, 20, 5), (16, 13, 30), (17, 8, 8), (40, 100, 62)])
def test_int_mm_padding_matches_plain(dev, M, K, N):
    """``ops.quantize.int8_matmul`` pads what ``torch._int_mm`` refuses on
    the card (M <= 16, K or N not a multiple of 8): its int32 product
    equals the plain version's exactly."""
    from uasr_torch.ops.quantize import int8_matmul, int8_matmul_reference

    g = torch.Generator().manual_seed(M * K + N)
    a = torch.randint(-127, 128, (M, K), generator=g, dtype=torch.int8).to(dev)
    b = torch.randint(-127, 128, (N, K), generator=g, dtype=torch.int8).to(dev)
    got = int8_matmul(a, b)
    assert got.dtype == torch.int32 and got.shape == (M, N) and got.is_cuda
    assert torch.equal(got, int8_matmul_reference(a, b))
    assert torch.equal(got.cpu(), int8_matmul(a.cpu(), b.cpu()))


# ------------------------------------------------------- K-norm, K-adam

# the benchmark's librispeech BiGRU (22 leaves, 15,031,264 parameters); odd
# sizes (scalar tails) and zero-size leaves (first, inside, last: chunks
# the kernels' search must step over) past one table's 64 leaves, every
# other leaf a view 4 bytes off its buffer's start (no float4)
ADAM_LEAVES = {
    "bigru": [576, 64, 64, 64, 36864, 64, 64, 64, 3932160, 1572864, 3072, 3072, 3145728,
              1572864, 3072, 3072, 3145728, 1572864, 3072, 3072, 32768, 32],
    "odd": [0, 1, 5, 4099, 0, 0, 8195, 3] + [7] * 66 + [0],
}


def _adam_problem(dev, sizes, norm, dtype=torch.float32, seed=0, fresh=False,
                  misaligned=False):
    """Leaves of ``sizes``: parameters and gradients of ``dtype`` (the
    gradients scaled to global norm ``norm``) and f32 moments, at
    mid-training values or, ``fresh``, parameters and moments zero; with
    ``misaligned`` every other leaf is a view 4 bytes past its buffer's
    start."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def leaves(fn, dt=torch.float32):
        out = []
        for i, n in enumerate(sizes):
            off = i % 2 if misaligned else 0
            buf = torch.empty(n + off, device=dev, dtype=dt)
            buf[off:] = fn(torch.randn(n, device=dev, generator=gen))
            out.append(buf[off:])
        return out

    grads = leaves(lambda x: x, dtype)
    total = float(torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads)))
    with torch.no_grad():
        for g in grads:
            g.mul_(norm / total)
    scale = 0.0 if fresh else 0.01
    params = leaves(lambda x: 100 * scale * x, dtype)
    mu = leaves(lambda x: scale * x)
    nu = leaves(lambda x: (scale * x) ** 2)
    return params, grads, mu, nu


def _copies(*trees):
    """Copies that keep each tensor's offset from 16-byte alignment."""
    def copy(t):
        off = t.data_ptr() % 16 // t.element_size()
        out = torch.empty(t.numel() + off, dtype=t.dtype, device=t.device)[off:].view(t.shape)
        return out.copy_(t)

    return [[copy(t) for t in tree] for tree in trees]


ADAM = dict(max_norm=5.0, b1=0.9, b2=0.999, eps=1e-8)


def _plain_update(params, grads, mu, nu, count=3, lr=6e-4, g_norm=None):
    if g_norm is None:
        g_norm = cuda_adam.sq_norms_reference(grads, [False] * len(grads))[2]
    cuda_adam.clip_adam_reference(params, grads, mu, nu, g_norm, **ADAM,
                                  **dict(zip(("bc1", "bc2", "step_size"),
                                             cuda_adam.host_scalars(count, 0.9, 0.999, lr))))
    return g_norm


def _fused_update(params, grads, mu, nu, count=3, lr=6e-4, g_norm=None):
    if g_norm is None:
        g_norm = cuda_adam.sq_norms_cuda(grads, [False] * len(grads))[2]
    cuda_adam.clip_adam_cuda(params, grads, mu, nu, g_norm, **ADAM,
                             **dict(zip(("bc1", "bc2", "step_size"),
                                        cuda_adam.host_scalars(count, 0.9, 0.999, lr))))
    return g_norm


@pytest.mark.parametrize("leaves", sorted(ADAM_LEAVES))
@pytest.mark.parametrize("clip", ["below", "above"])
def test_fused_adam_matches_plain(dev, leaves, clip):
    """K-norm + K-adam against the per-leaf plain version on the same f32
    leaves: the norm within rtol 1e-6 (a ShardPlan's two sums of squares
    within 2e-6); K-adam from the plain norm gives
    the parameters, mu and nu bit for bit on both sides of the clip, and
    the whole fused update (its own norm) does too below the clip. Above
    it the norm's summation order shows: the fused update from zero
    parameters and moments (each then its update, with no cancellation to
    magnify the last bits) is within rtol 1e-6. Two launches a table: 2
    for the 22 leaves, 4 past one table."""
    sizes = ADAM_LEAVES[leaves]
    norm = 2.5 if clip == "below" else 20.0
    tables = len(cuda_adam.plan_tables(sizes))
    problem = _adam_problem(dev, sizes, norm, misaligned=leaves == "odd")
    ref = _copies(*problem)
    ref_norm = _plain_update(*ref)
    got = _copies(*problem)
    before = cuda_adam.LAUNCHES
    fused_norm = _fused_update(*got)
    torch.cuda.synchronize()
    assert cuda_adam.LAUNCHES == before + 2 * tables
    torch.testing.assert_close(fused_norm, ref_norm, rtol=1e-6, atol=0)
    # a ShardPlan's split: the sums of squares of the sharded leaves and of
    # the rest (squares, so twice the norm's rtol)
    split = [i % 3 == 0 for i in range(len(sizes))]
    for x, y in zip(cuda_adam.sq_norms_cuda(problem[1], split),
                    cuda_adam.sq_norms_reference(problem[1], split)):
        torch.testing.assert_close(x, y, rtol=2e-6, atol=0)
    alone = _copies(*problem)
    _fused_update(*alone, g_norm=ref_norm)
    for fused in [alone, got] if clip == "below" else [alone]:
        for a, b in zip(fused, ref):
            for x, y in zip(a, b):
                assert torch.equal(x, y)
    if clip == "above":
        zero = _adam_problem(dev, sizes, norm, fresh=True, misaligned=leaves == "odd")
        ref, got = _copies(*zero), _copies(*zero)
        _plain_update(*ref)
        _fused_update(*got)
        for a, b in zip(got, ref):
            for x, y in zip(a, b):
                torch.testing.assert_close(x, y, rtol=1e-6, atol=0)


def test_fused_adam_bf16_leaves_match_f32_formula(dev):
    """bf16 parameters and gradients: K-norm and K-adam read them into f32;
    mu, nu and the parameters (rounded once to bf16) match the plain
    version evaluated on f32 copies within rtol 1e-6, below the clip."""
    sizes = ADAM_LEAVES["bigru"]
    params, grads, mu, nu = _adam_problem(dev, sizes, 2.5, dtype=torch.bfloat16, seed=1)
    ref = [[p.float() for p in params], [g.float() for g in grads], *_copies(mu, nu)]
    _plain_update(*ref)
    torch.testing.assert_close(cuda_adam.sq_norms_cuda(grads, [False] * len(grads))[2],
                               cuda_adam.sq_norms_reference(ref[1], [False] * len(grads))[2],
                               rtol=1e-6, atol=0)
    _fused_update(params, grads, mu, nu)
    for x, y in zip(params, ref[0]):
        assert x.dtype == torch.bfloat16
        torch.testing.assert_close(x.float(), y.to(torch.bfloat16).float(), rtol=1e-6, atol=0)
    for a, b in ((mu, ref[2]), (nu, ref[3])):
        for x, y in zip(a, b):
            torch.testing.assert_close(x, y, rtol=1e-6, atol=0)


def test_fused_adam_is_deterministic(dev):
    """Two runs of the same fused update give the same bits: the norm,
    the parameters and both moments."""
    problem = _adam_problem(dev, ADAM_LEAVES["bigru"], 20.0, seed=2)
    runs = []
    for _ in range(2):
        trees = _copies(*problem)
        runs.append((_fused_update(*trees).clone(), trees))
    assert torch.equal(runs[0][0], runs[1][0])
    for a, b in zip(runs[0][1], runs[1][1]):
        for x, y in zip(a, b):
            assert torch.equal(x, y)


def test_clip_adam_runs_the_kernels_with_grad_accum(dev):
    """``ClipAdam`` with grad_accum 2 on CUDA: the accumulating call makes
    one launch (the norm it reports) and changes no parameter; the second
    runs K-norm twice (its own gradient's norm, the mean's) and K-adam,
    and lands within rtol 1e-6 of the same optimizer on the CPU."""
    from uasr_torch import train
    sizes = [576, 4099, 32768]
    runs = []
    for d in (dev, torch.device("cpu")):
        opt = train.ClipAdam(lambda step: 1e-3, 5.0, accum=2)
        gen = torch.Generator().manual_seed(4)
        params = {f"w{i}": torch.randn(n, generator=gen).to(d) for i, n in enumerate(sizes)}
        state = opt.init(params)
        start = {k: p.clone() for k, p in params.items()}
        for call in range(2):
            grads = {k: torch.randn(p.shape, generator=gen).to(d) for k, p in params.items()}
            before = cuda_adam.LAUNCHES
            state, g_norm = opt.update(grads, state, params)
            if d.type == "cuda":
                torch.cuda.synchronize()
                assert cuda_adam.LAUNCHES == before + (1 if call == 0 else 3)
            if call == 0:
                assert all(torch.equal(p, start[k]) for k, p in params.items())
        assert state["micro"] == 0 and state["count"] == 1
        runs.append({k: p.cpu() for k, p in params.items()})
    for k in runs[1]:
        torch.testing.assert_close(runs[0][k], runs[1][k], rtol=1e-6, atol=1e-9)


def test_fused_adam_rejects_bad_input(dev):
    params, grads, mu, nu = _adam_problem(dev, [64, 128], 1.0)
    norm = cuda_adam.sq_norms_cuda(grads, [False, False])[2]
    cases = [
        ([p.half() for p in params], grads, mu, nu, norm, "float32 or bfloat16 parameters"),
        (params, [g.half() for g in grads], mu, nu, norm, "float32 or bfloat16 gradients"),
        (params, grads, [m.bfloat16() for m in mu], nu, norm, "float32 moments"),
        (params, grads[:1], mu, nu, norm, "2 parameters, 1 gradients"),
        (params, [g[:10] for g in grads], mu, nu, norm, "shapes differ"),
        (params, grads, [m.cpu() for m in mu], nu, norm, "one CUDA device"),
        (params, grads, mu, nu, norm.reshape(1), "0-d float32"),
    ]
    for p, g, m, v, n, match in cases:
        with pytest.raises(ValueError, match=match):
            _fused_update(p, g, m, v, g_norm=n)
    with pytest.raises(ValueError, match="contiguous"):
        _fused_update([params[0].reshape(8, 8).t(), params[1]], [grads[0].reshape(8, 8),
                      grads[1]], [mu[0].reshape(8, 8), mu[1]], [nu[0].reshape(8, 8), nu[1]],
                      g_norm=norm)
