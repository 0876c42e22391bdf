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
