"""K2's plain version (uasr_torch.models.cuda_gru.bigru_scan_reference) and
the port's BiGRU against the JAX package on the CPU: the Pallas two-stream
kernel in interpret mode and flax BiGRU(use_pallas=False)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from uasr.models.layers import BiGRU as FlaxBiGRU
from uasr.models.pallas_gru import pallas_bigru_scan
from uasr_torch.models import cuda_gru
from uasr_torch.models.layers import BiGRU

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 0.02)}


def _tmask(T, lengths):
    tpos = np.arange(T)[:, None]
    return np.stack([tpos < lengths[None], tpos >= (T - lengths)[None]], axis=1)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("seed", [0, 1])
def test_reference_matches_pallas_interpret(dtype, seed):
    jdt, tdt, atol = DTYPES[dtype]
    rng = np.random.RandomState(seed)
    T, B, H = 11, 4, 8
    p0, p1 = (rng.randn(T, B, 3 * H).astype(np.float32) * 0.5 for _ in range(2))
    wh = rng.randn(2, H, 3 * H).astype(np.float32) * 0.3
    bh = rng.randn(2, 3 * H).astype(np.float32) * 0.1
    tmask = _tmask(T, np.array([T, T - 3, 5, 1]))
    ref = pallas_bigru_scan(*(jnp.asarray(a, jdt) for a in (p0, p1, wh, bh)),
                            jnp.asarray(tmask), True)
    got = cuda_gru.bigru_scan_reference(*(torch.tensor(a).to(tdt) for a in (p0, p1, wh, bh)),
                                        torch.tensor(tmask))
    assert got.dtype == tdt and got.shape == (T, B, 2 * H)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref.astype(jnp.float32)),
                               rtol=0, atol=atol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_bigru_matches_flax_scan(dtype):
    """The port's BiGRU (use_pallas on CPU -> K2's plain version) on the
    flax parameters against flax's lax.scan BiGRU, ragged lengths."""
    jdt, tdt, atol = DTYPES[dtype]
    rng = np.random.RandomState(2)
    T, B, D, H = 13, 4, 6, 8
    x = rng.randn(T, B, D).astype(np.float32)
    lengths = np.array([T, 9, 1, 4], np.int32)
    flax_gru = FlaxBiGRU(H, dtype=jdt, use_pallas=False, time_major=True)
    params = flax_gru.init(jax.random.PRNGKey(0), x, lengths)
    ref = jax.jit(flax_gru.apply)(params, x, lengths)
    gru = BiGRU(D, H, dtype=tdt, use_pallas=True)
    gru.load_state_dict({k: torch.tensor(np.asarray(v))
                         for k, v in params["params"].items()})
    with torch.no_grad():
        got = gru(torch.tensor(x), torch.tensor(lengths, dtype=torch.long))
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref.astype(jnp.float32)),
                               rtol=0, atol=atol)
    # padding frames are exactly zero
    assert float(got[9:, 1].abs().max()) == 0.0


def test_cpu_tensors_run_plain_version():
    rng = np.random.RandomState(4)
    T, B, H = 5, 2, 4
    args = [torch.tensor(rng.randn(*s).astype(np.float32))
            for s in ((T, B, 3 * H), (T, B, 3 * H), (2, H, 3 * H), (2, 3 * H))]
    tmask = torch.tensor(_tmask(T, np.array([T, 2])))
    before = cuda_gru.LAUNCHES
    np.testing.assert_array_equal(cuda_gru.bigru_scan(*args, tmask).numpy(),
                                  cuda_gru.bigru_scan_reference(*args, tmask).numpy())
    assert cuda_gru.LAUNCHES == before


def _grad_problem(T, seed):
    rng = np.random.RandomState(seed)
    B, H = 4, 8
    p0, p1 = (rng.randn(T, B, 3 * H).astype(np.float32) * 0.5 for _ in range(2))
    wh = rng.randn(2, H, 3 * H).astype(np.float32) * 0.3
    bh = rng.randn(2, 3 * H).astype(np.float32) * 0.1
    tmask = _tmask(T, np.array([T, T - 3, 5, 1]))
    w_out = rng.randn(T, B, 2 * H).astype(np.float32)
    return (p0, p1, wh, bh), tmask, w_out


# f32: the bar of tests/test_pallas_gru.py. bf16: both sides round dxp,
# dhn and dhproj to bf16 at the same points and agree bit for bit at these
# sizes; the bar allows one bf16 ulp (2^-8 relative) of the largest
# gradient (~4 here), for a product that another summation order would
# round the other way.
GRAD_BARS = {"float32": dict(atol=2e-4, rtol=1e-3), "bfloat16": dict(atol=2e-2, rtol=1e-2)}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("T", [10, 11])  # even T: dy_fused branch of _bwd2_rule; odd: padded
def test_backward_matches_pallas_interpret(dtype, T):
    """d(p0, p1, wh, bh) of a weighted sum of the output through the
    port's autograd function on CPU tensors (K2 / K2-bwd's plain versions)
    against jax.grad of pallas_bigru_scan in interpret mode."""
    jdt, tdt, _ = DTYPES[dtype]
    arrays, tmask, w_out = _grad_problem(T, seed=T)

    def jloss(*a):
        out = pallas_bigru_scan(*a, jnp.asarray(tmask), True).astype(jnp.float32)
        return jnp.sum(out * w_out)

    j_grads = jax.grad(jloss, argnums=(0, 1, 2, 3))(*(jnp.asarray(a, jdt) for a in arrays))
    leaves = [torch.tensor(a).to(tdt).requires_grad_() for a in arrays]
    out = cuda_gru.bigru_scan(*leaves, torch.tensor(tmask))
    (out.float() * torch.tensor(w_out)).sum().backward()
    for leaf, jg, name in zip(leaves, j_grads, ["dp0", "dp1", "dwh", "dbh"]):
        assert leaf.grad.dtype == tdt, name
        np.testing.assert_allclose(leaf.grad.float().numpy(), np.asarray(jg.astype(jnp.float32)),
                                   err_msg=name, **GRAD_BARS[dtype])


@pytest.mark.parametrize("T", [1, 6])
def test_backward_plain_matches_autograd_of_forward(T):
    """K2-bwd's plain version against autograd through K2's plain version
    (f32, so the two differ only in summation order)."""
    arrays, tmask, w_out = _grad_problem(T, seed=20 + T)
    grads = []
    for fn in (cuda_gru.bigru_scan, cuda_gru.bigru_scan_reference):
        leaves = [torch.tensor(a, dtype=torch.float64).float().requires_grad_() for a in arrays]
        (fn(*leaves, torch.tensor(tmask)) * torch.tensor(w_out)).sum().backward()
        grads.append([x.grad for x in leaves])
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("T", [1, 7])
def test_bigru_bwd_is_the_grouped_backward_reversed(dtype, T):
    """K2-bwd is K5-bwd with two groups, group 1 in reversed frames: the
    grouped backward's plain pipeline (coefficients, then the reverse chain)
    fed K2's tensors in the kernel-time order that K2-bwd's layout addresses
    (stream 1's step u is frame T-1-u; its h_prev is out's frame T-u, the
    shift of _bwd2_rule) gives K2-bwd's plain version: within 1e-6 of the
    largest gradient in f32 (summation order), one bf16 ulp of it in bf16.
    Ragged T = 7 with rows of length 1 and T, and T = 1."""
    tdt = DTYPES[dtype][1]
    rng = np.random.RandomState(40 + T)
    B, H = 3, 16
    p0, p1 = (torch.tensor(rng.randn(T, B, 3 * H).astype(np.float32) * 0.5).to(tdt)
              for _ in range(2))
    wh = torch.tensor(rng.randn(2, H, 3 * H).astype(np.float32) * 0.3).to(tdt)
    bh = torch.tensor(rng.randn(2, 3 * H).astype(np.float32) * 0.1).to(tdt)
    tmask = torch.tensor(_tmask(T, np.array([1, T, (T + 1) // 2])))
    dout = torch.tensor(rng.randn(T, B, 2 * H).astype(np.float32)).to(tdt)
    out = cuda_gru.bigru_scan_reference(p0, p1, wh, bh, tmask)
    ref = cuda_gru.bigru_scan_bwd_reference(p0, p1, wh, bh, tmask, out, dout)

    kernel_time = cuda_gru._kernel_time
    ys = kernel_time(out[..., :H], out[..., H:])
    h_prev = torch.cat([torch.zeros_like(ys[:1]), ys[:-1]])
    assert torch.equal(h_prev[1:, 1], out[1:, :, H:].flip(0))  # frame T-u at step u
    c4, ch = cuda_gru.gru_bwd_coeffs_reference(kernel_time(p0, p1), wh, bh, tmask, ys)
    e = cuda_gru._reverse_chain(c4, ch, kernel_time(dout[..., :H], dout[..., H:]), wh, tdt)
    got = (e[:, 0, ..., :3 * H], e[:, 1, ..., :3 * H].flip(0), e[:, 0, ..., 3 * H:],
           e[:, 1, ..., 3 * H:].flip(0))
    scale = max(float(r.float().abs().max()) for r in ref)
    tol = 1e-6 * scale if dtype == "float32" else 2.0 ** (np.floor(np.log2(scale)) - 7)
    for a, r in zip(got, ref):
        assert a.dtype == tdt and a.shape == r.shape
        assert float((a.float() - r.float()).abs().max()) <= tol


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("T", [1, 7])
def test_bigru_fwd_is_the_grouped_forward_reversed(dtype, T):
    """K2 is K5 with two groups, group 1 in reversed frames: the grouped
    forward's plain version fed K2's inputs in the kernel-time order that
    K2's layout addresses (stream 1's step u is frame T-1-u), with group
    1's states flipped back to frame order beside group 0's, is K2's plain
    version bit for bit (both run the same ops on the same rows). Ragged
    T = 7 with rows of length 1 and T, and T = 1."""
    tdt = DTYPES[dtype][1]
    rng = np.random.RandomState(60 + T)
    B, H = 3, 16
    p0, p1 = (torch.tensor(rng.randn(T, B, 3 * H).astype(np.float32) * 0.5).to(tdt)
              for _ in range(2))
    wh = torch.tensor(rng.randn(2, H, 3 * H).astype(np.float32) * 0.3).to(tdt)
    bh = torch.tensor(rng.randn(2, 3 * H).astype(np.float32) * 0.1).to(tdt)
    tmask = torch.tensor(_tmask(T, np.array([1, T, (T + 1) // 2])))
    ref = cuda_gru.bigru_scan_reference(p0, p1, wh, bh, tmask)
    ys = cuda_gru.gru_scan_reference(torch.stack([p0, p1.flip(0)], 1), wh, bh, tmask)
    got = torch.cat([ys[:, 0], ys[:, 1].flip(0)], -1)
    assert got.dtype == tdt and got.shape == (T, B, 2 * H)
    assert torch.equal(got, ref)
