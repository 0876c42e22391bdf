"""Training the recurrent encoders: the plain versions of K5's coefficient
outputs, K5-bwd and K8 (uasr_torch.models.cuda_gru) against the JAX
package's Pallas GRU kernel in interpret mode, and three CTCTrainer steps
of uni_gru and lc_bigru against JAX's CTCTrainer on the CPU.

Kernel level: the coefficients against ``_fwd(..., save_coeffs=True)``
(f32 1e-5, bf16 one bf16 ulp of the largest); d(xproj, wh, bh) of a
weighted sum of ys through ``GRUScan`` on CPU tensors against ``jax.grad``
of ``pallas_gru_scan(..., interpret=True)`` with BWD_IMPL set to the same
value on both sides (f32 atol 2e-4 / rtol 1e-3 as tests/test_pallas_gru.py;
bf16 one bf16 ulp of each gradient's largest magnitude). Cases: T = 1, a
length-0 row, G in {1, 2}, T odd (not a multiple of the JAX BWD_TIME_TILE).

Error budget of the card's f32 tensor-core products: K5-bwd's plain
version with its products emulated as 3xTF32 against the f32 plain version
at T = 24, H = 384 (the card's f32 bar, 1e-4 of the largest gradient), the
same for K2-bwd at H = 512 (K = 3H = 1536), and K5's plain version so at
T = 300 and T = 24 (1e-4).

Trainer level (f32, H = 16, 2 layers, B = 4, SpecAugment off): the JAX side
runs gru_pallas with pallas_gru_scan rebound to interpret mode, the port
its kernel flags on CPU tensors (plain versions); loss and grad_norm rtol
1e-4 per step, parameters after step 3 atol 1e-4, under both BWD_IMPL.
"""

import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import uasr.models.pallas_gru as jax_gru
from uasr import train as jax_train
from uasr.config import Config as JaxConfig
from uasr.config import FrontendConfig as JaxFrontendConfig
from uasr.config import ModelConfig as JaxModelConfig
from uasr.config import TrainConfig as JaxTrainConfig
from uasr.data.dataset import Batch as JaxBatch
from uasr_torch import config as tc
from uasr_torch import train
from uasr_torch.convert import flax_to_state_dict
from uasr_torch.data.dataset import batch_iterator, make_synthetic_dataset
from uasr_torch.models import cuda_gru

DT = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}
GRAD_F32 = dict(atol=2e-4, rtol=1e-3)
LOSS_RTOL = 1e-4
PARAM_ATOL = 1e-4


def _bf16_ulp(x) -> float:
    """One bf16 ulp at the largest magnitude of x (8 significant bits)."""
    m = float(np.abs(np.asarray(x, np.float32)).max())
    return 2.0 ** (np.floor(np.log2(m)) - 7) if m > 0 else 0.0


def _problem(T, G, B, H, seed):
    rng = np.random.RandomState(seed)
    xp = (0.5 * rng.randn(T, G, B, 3 * H)).astype(np.float32)
    wh = (rng.randn(G, H, 3 * H) / np.sqrt(H)).astype(np.float32)
    bh = (0.1 * rng.randn(G, 3 * H)).astype(np.float32)
    lengths = rng.randint(0, T + 1, (G, B))
    lengths[0, 0] = T
    lengths[-1, -1] = 0  # a row that never steps
    tmask = np.arange(T)[:, None, None] < lengths[None]
    w_out = rng.randn(T, G, B, H).astype(np.float32)
    return (xp, wh, bh), tmask, w_out


# T = 1; G = 1 and 2; odd T (the JAX backward pads to its time tile of 2);
# a batch of one row
GRU_CASES = [(1, 1, 3, 8), (1, 2, 2, 16), (7, 1, 4, 16), (9, 2, 3, 8), (6, 2, 1, 24)]


@pytest.mark.parametrize("dtype", sorted(DT))
@pytest.mark.parametrize("T,G,B,H", GRU_CASES)
def test_coefficients_match_pallas_save_coeffs(T, G, B, H, dtype):
    tdt, jdt = DT[dtype]
    (xp, wh, bh), tmask, _ = _problem(T, G, B, H, T + G + B)
    ys, c4, ch = jax_gru._fwd(jnp.asarray(xp, jdt), jnp.asarray(wh, jdt), jnp.asarray(bh, jdt),
                              jnp.asarray(tmask), True, save_coeffs=True)
    tys, tc4, tch = cuda_gru.gru_scan_reference(
        *(torch.tensor(a).to(tdt) for a in (xp, wh, bh)), torch.tensor(tmask), save_coeffs=True)
    assert tc4.dtype == tdt and tch.dtype == torch.float32
    assert tc4.shape == (T, G, B, 4 * H) and tch.shape == (T, G, B, H)
    for got, want in ((tys, ys), (tc4, c4), (tch, ch)):
        want = np.asarray(want, np.float32)
        tol = 1e-5 if dtype == "float32" else _bf16_ulp(want)
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)
    # a row that never steps: every coefficient 0, the carry's 1
    zero = torch.tensor(~tmask.any(0))  # [G, B]
    assert not tc4.permute(1, 2, 0, 3)[zero].any()
    assert bool((tch.permute(1, 2, 0, 3)[zero] == 1).all())


@pytest.mark.parametrize("impl", ["fused", "linear"])
@pytest.mark.parametrize("dtype", sorted(DT))
@pytest.mark.parametrize("T,G,B,H", GRU_CASES)
def test_backward_matches_pallas_interpret(T, G, B, H, dtype, impl, monkeypatch):
    """K5-bwd (fused) or K5's coefficients + K8 (linear), plain versions,
    through GRUScan against jax.grad of the Pallas kernel's custom VJP."""
    monkeypatch.setattr(jax_gru, "BWD_IMPL", impl)
    monkeypatch.setattr(cuda_gru, "BWD_IMPL", impl)
    tdt, jdt = DT[dtype]
    arrays, tmask, w_out = _problem(T, G, B, H, 10 * T + G + B)

    def jloss(xp, wh, bh):
        ys = jax_gru.pallas_gru_scan(xp, wh, bh, jnp.asarray(tmask), True)
        return jnp.sum(ys.astype(jnp.float32) * w_out)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(a, jdt) for a in arrays))
    leaves = [torch.tensor(a).to(tdt).requires_grad_() for a in arrays]
    before = (cuda_gru.LAUNCHES_GRU, cuda_gru.LAUNCHES_GRU_BWD, cuda_gru.LAUNCHES_GRU_LIN)
    ys = cuda_gru.gru_scan(*leaves, torch.tensor(tmask))
    (ys.float() * torch.tensor(w_out)).sum().backward()
    # CPU tensors: the plain versions, no launch
    assert (cuda_gru.LAUNCHES_GRU, cuda_gru.LAUNCHES_GRU_BWD, cuda_gru.LAUNCHES_GRU_LIN) == before
    for leaf, jg, name in zip(leaves, want, ["dxproj", "dwh", "dbh"]):
        jg = np.asarray(jg.astype(jnp.float32))
        assert leaf.grad.dtype == tdt and leaf.grad.shape == leaf.shape, name
        bar = GRAD_F32 if dtype == "float32" else dict(atol=_bf16_ulp(jg), rtol=0)
        np.testing.assert_allclose(leaf.grad.float().numpy(), jg, err_msg=name, **bar)


def test_gru_scan_runs_the_forward_alone_without_a_gradient(monkeypatch):
    """No gradient to take: the plain forward only, as JAX's custom VJP
    runs the primal alone (no coefficients saved under ``linear``)."""
    monkeypatch.setattr(cuda_gru, "BWD_IMPL", "linear")
    (xp, wh, bh), tmask, _ = _problem(5, 1, 2, 8, 0)
    args = [torch.tensor(a, requires_grad=True) for a in (xp, wh, bh)]
    with torch.no_grad():
        ys = cuda_gru.gru_scan(*args, torch.tensor(tmask))
    assert ys.grad_fn is None
    torch.testing.assert_close(ys, cuda_gru.gru_scan_reference(*args, torch.tensor(tmask)),
                               rtol=0, atol=0)
    assert cuda_gru.gru_scan(*args, torch.tensor(tmask)).grad_fn is not None


def _tf32(x):
    """x rounded to TF32 (10 mantissa bits) to nearest, ties away from zero,
    as the card's cvt.rna.tf32.f32 rounds it."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split_tf32(x):
    """(hi, lo) = (tf32(x), tf32(x - hi))."""
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _mm_3xtf32(a, b, b_split=None):
    """a @ b as K5-bwd's f32 tensor-core products take it: hi = tf32(x),
    lo = tf32(x - hi) for both operands, a_hi b_hi + (a_lo b_hi + a_hi b_lo)
    with the TF32 products exact in f32 and f32 sums. ``b_split``: b's
    (hi, lo), split once for a constant b."""
    a_hi, a_lo = _split_tf32(a)
    b_hi, b_lo = b_split if b_split is not None else _split_tf32(b)
    return a_hi @ b_hi + (a_lo @ b_hi + a_hi @ b_lo)


def _grouped_bwd(mm, xp, wh, bh, tmask, ys, dy):
    """The plain grouped backward (K5-bwd's, and K2-bwd's at G = 2) in f32
    with its two products, the coefficient kernel's h_prev @ wh and the
    chain's per-step dhproj @ wh^T, taken by ``mm``. Returns (dxp, dhn)."""
    T, G, B, H = ys.shape
    h_prev = torch.cat([torch.zeros_like(ys[:1]), ys[:-1]])
    hp = mm(h_prev, wh) + bh[:, None, :]
    r, z, n, hn = cuda_gru._gates(xp, hp, h_prev)
    c4, ch = cuda_gru._coeffs(r, z, n, hn, h_prev, tmask.to(torch.float32)[..., None])
    w_t = wh.transpose(1, 2)
    dh = torch.zeros(G, B, H)
    out = torch.empty(T, G, B, 4 * H)
    for t in reversed(range(T)):
        d = dh + dy[t]
        e = c4[t] * d.repeat(1, 1, 4)
        out[t] = e
        dh = ch[t] * d + mm(torch.cat([e[..., :2 * H], e[..., 3 * H:]], -1), w_t)
    return out[..., :3 * H], out[..., 3 * H:]


def test_3xtf32_products_hold_the_card_bar():
    """The error budget of K5-bwd's f32 tensor-core products, set on the
    CPU: the plain K5-bwd with its coefficient product h_prev @ wh and its
    chain's per-step products taken as 3xTF32 stays within the card's f32
    bar (1e-4 of the largest gradient) of the f32 plain version at the
    lc_bigru window shape (T = 24, H = 384; B = 8), and over a hundred
    times closer than single-pass TF32 (operands rounded once), which lands
    at about the bar itself."""
    T, G, B, H = 24, 1, 8, 384
    arrays, m, _ = _problem(T, G, B, H, 24)
    xp, wh, bh = (torch.tensor(a) for a in arrays)
    tmask = torch.tensor(m)
    dy = torch.tensor(np.random.RandomState(25).randn(T, G, B, H).astype(np.float32))
    ys = cuda_gru.gru_scan_reference(xp, wh, bh, tmask)
    ref = cuda_gru.gru_scan_bwd_reference(xp, wh, bh, tmask, ys, dy)

    scale = max(1.0, max(float(x.abs().max()) for x in ref))
    err3, err1 = (max(float((a - x).abs().max())
                      for a, x in zip(_grouped_bwd(mm, xp, wh, bh, tmask, ys, dy), ref))
                  for mm in (_mm_3xtf32, lambda a, b: _tf32(a) @ _tf32(b)))
    assert 0 < err3 <= 1e-4 * scale
    assert err1 > 100 * err3


def test_3xtf32_products_hold_the_bigru_bar():
    """The same budget for K2-bwd, which runs K5-bwd's two products at
    G = 2: at the BiGRU's widths (H = 512, so the chain's K = 3H = 1536;
    T = 40, B = 4, lengths T, 1 and between), K2's tensors in kernel time
    (stream 1's frames reversed) through the grouped backward with both
    products as 3xTF32 stay within 1e-4 of the largest gradient of K2-bwd's
    f32 plain version; single-pass TF32 lands over a hundred times further off."""
    T, B, H = 40, 4, 512
    rng = np.random.RandomState(26)
    p0, p1 = (torch.tensor((0.5 * rng.randn(T, B, 3 * H)).astype(np.float32)) for _ in range(2))
    wh = torch.tensor((rng.randn(2, H, 3 * H) / np.sqrt(H)).astype(np.float32))
    bh = torch.tensor((0.1 * rng.randn(2, 3 * H)).astype(np.float32))
    lengths = np.array([T, 1, 25, 33])
    tpos = np.arange(T)[:, None]
    tmask = torch.tensor(np.stack([tpos < lengths[None], tpos >= (T - lengths)[None]], 1))
    dout = torch.tensor(rng.randn(T, B, 2 * H).astype(np.float32))
    out = cuda_gru.bigru_scan_reference(p0, p1, wh, bh, tmask)
    ref = cuda_gru.bigru_scan_bwd_reference(p0, p1, wh, bh, tmask, out, dout)
    kt = cuda_gru._kernel_time
    args = (kt(p0, p1), wh, bh, tmask, kt(out[..., :H], out[..., H:]),
            kt(dout[..., :H], dout[..., H:]))

    def err(mm):
        dxp, dhn = _grouped_bwd(mm, *args)
        got = (dxp[:, 0], dxp[:, 1].flip(0), dhn[:, 0], dhn[:, 1].flip(0))
        return max(float((a - x).abs().max()) for a, x in zip(got, ref))

    scale = max(1.0, max(float(x.abs().max()) for x in ref))
    assert err(torch.matmul) <= 1e-6 * scale  # the kernel-time order itself
    err3, err1 = err(_mm_3xtf32), err(lambda a, b: _tf32(a) @ _tf32(b))
    assert 0 < err3 <= 1e-4 * scale
    assert err1 > 100 * err3


@pytest.mark.parametrize("T", [300, 24])
def test_3xtf32_products_hold_the_forward_bar(T):
    """The error budget of K5's f32 tensor-core products, set on the CPU:
    the plain K5 (``gru_scan_reference``'s recurrence) with each step's
    h_prev @ wh taken as 3xTF32 stays within the card's f32 bar (1e-4) of
    the f32 plain version, offline (T = 300, where the carry's errors
    compound) and at the lc_bigru windows (T = 24), H = 384, B = 8; single-
    pass TF32 (operands rounded once) lands over a hundred times further
    off."""
    G, B, H = 1, 8, 384
    arrays, m, _ = _problem(T, G, B, H, T + 1)
    xp, wh, bh = (torch.tensor(a) for a in arrays)
    mask = torch.tensor(m).to(torch.float32)[..., None]
    ref = cuda_gru.gru_scan_reference(xp, wh, bh, torch.tensor(m))

    def fwd(mm):
        h = torch.zeros(G, B, H)
        ys = []
        for t in range(T):
            r, z, n, _ = cuda_gru._gates(xp[t], mm(h, wh) + bh[:, None, :], h)
            h = mask[t] * ((1.0 - z) * n + z * h) + (1.0 - mask[t]) * h
            ys.append(h)
        return torch.stack(ys)

    assert float((fwd(torch.matmul) - ref).abs().max()) <= 1e-6  # the recurrence itself
    # wh is constant over the steps: split and round it once
    wh_split, wh_tf32 = _split_tf32(wh), _tf32(wh)
    err3, err1 = (float((fwd(mm) - ref).abs().max())
                  for mm in (lambda a, b: _mm_3xtf32(a, b, wh_split),
                             lambda a, b: _tf32(a) @ wh_tf32))
    assert 0 < err3 <= 1e-4
    assert err1 > 100 * err3


# ------------------------------------------------------------- trainer


def _batches(n, seed=0):
    examples, vocab = make_synthetic_dataset(num_utts=4 * n, num_phones=6, seed=seed)
    return list(itertools.islice(batch_iterator(examples, 4, 16000, 8, shuffle=False), n)), vocab


def _model_kw(encoder):
    kw = dict(encoder=encoder, hidden_size=16, num_gru_layers=2)
    if encoder == "lc_bigru":
        kw.update(lc_chunk=4, lc_lookahead=2)
    return kw


@pytest.mark.parametrize("impl", ["fused", "linear"])
@pytest.mark.parametrize("encoder", ["uni_gru", "lc_bigru"])
def test_three_steps_match_jax_ctc_trainer(encoder, impl, monkeypatch):
    monkeypatch.setattr(jax_gru, "BWD_IMPL", impl)
    monkeypatch.setattr(cuda_gru, "BWD_IMPL", impl)
    pallas = jax_gru.pallas_gru_scan
    monkeypatch.setattr(jax_gru, "pallas_gru_scan",
                        lambda xp, wh, bh, tmask: pallas(xp, wh, bh, tmask, True))
    batches, vocab = _batches(3, seed=1)
    kw = _model_kw(encoder)
    jcfg = JaxConfig(frontend=JaxFrontendConfig(num_mel_bins=16),
                     model=JaxModelConfig(gru_pallas=True, **kw),
                     train=JaxTrainConfig(lr=1e-3, lr_schedule="constant", total_steps=3),
                     vocab_size=len(vocab))
    jtrainer = jax_train.CTCTrainer(jcfg)
    jstate = jtrainer.init_state(jax.random.PRNGKey(0), batches[0])
    cfg = tc.Config(frontend=tc.FrontendConfig(num_mel_bins=16),
                    model=tc.ModelConfig(gru_pallas=True, **kw), ctc=tc.CTCConfig(use_pallas=True),
                    train=tc.TrainConfig(lr=1e-3, lr_schedule="constant"), vocab_size=len(vocab))
    trainer = train.CTCTrainer(cfg, device="cpu")
    trainer.model.load_state_dict(flax_to_state_dict(jax.tree.map(np.asarray, jstate.params),
                                                     cfg))
    state = trainer.init_state()
    step_fn = jtrainer.jitted_train_step()
    rng = jax.random.PRNGKey(1)
    before = (cuda_gru.LAUNCHES_GRU, cuda_gru.LAUNCHES_GRU_BWD, cuda_gru.LAUNCHES_GRU_LIN)
    for b in batches:
        jstate, jaux = step_fn(jstate, JaxBatch(*map(jnp.asarray, b)), rng)
        state, aux = trainer.train_step(state, b)
        np.testing.assert_allclose(float(aux["loss"]), float(jaux["loss"]), rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(aux["grad_norm"]), float(jaux["grad_norm"]),
                                   rtol=LOSS_RTOL)
    assert (cuda_gru.LAUNCHES_GRU, cuda_gru.LAUNCHES_GRU_BWD, cuda_gru.LAUNCHES_GRU_LIN) == before
    want = flax_to_state_dict(jax.tree.map(np.asarray, jstate.params), trainer.cfg)
    assert set(want) == set(state.params)
    for k, v in want.items():
        np.testing.assert_allclose(state.params[k].detach().numpy(), v.numpy(), atol=PARAM_ATOL,
                                   rtol=0, err_msg=k)
