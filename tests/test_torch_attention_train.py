"""Training the attention encoders: the plain version of K6-bwd
(uasr_torch.ops.cuda_attention.mhsa_bwd_reference, through MHSAttention)
against the JAX package's fused attention in interpret mode, and three
CTCTrainer steps of the transformer and the conformer against JAX's
CTCTrainer on the CPU.

Kernel level: d(q, k, v, bias) of a weighted sum of
``fused_dot_product_attention``'s output, the port's autograd on CPU tensors
against ``jax.vjp`` of the JAX wrapper with ``interpret=True`` (padding,
casts and the kernel's custom VJP on both sides). Bars: dq, dk, dv f32 atol
2e-5 (tests/test_pallas_attention.py), bf16 one bf16 ulp of each tensor's
largest magnitude; d_bias (f32) 1e-4 of its largest magnitude. Cases: T in
{16, 37} (37 padded to 40), a bias or none, a row with one valid key, f32
and bf16.

Trainer level (f32, d = 32, 2 heads, 2 blocks, B = 4, SpecAugment off; the
conformer's relative-position tables drawn N(0, 0.3^2) so its bias
gradient is not fed by a zero bias): attn_pallas on both sides, the JAX
kernel in interpret mode through UASR_PALLAS_ATTN; loss and grad_norm rtol
1e-4 per step, parameters after step 3 atol 1e-4. The key projections'
biases are the exception: their gradient is zero but for rounding (the
softmax ignores a constant per query row), so Adam moves them by rounding
noise on each side; their first-step gradient is held at the noise floor
and their moves to three Adam steps (<= 3 lr each).
"""

import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from uasr import train as jax_train
from uasr.config import Config as JaxConfig
from uasr.config import FrontendConfig as JaxFrontendConfig
from uasr.config import ModelConfig as JaxModelConfig
from uasr.config import TrainConfig as JaxTrainConfig
from uasr.data.dataset import Batch as JaxBatch
from uasr.ops.pallas_attention import fused_dot_product_attention as jax_fused
from uasr_torch import config as tc
from uasr_torch import train
from uasr_torch.convert import flax_to_state_dict
from uasr_torch.data.dataset import batch_iterator, make_synthetic_dataset
from uasr_torch.ops import cuda_attention

DT = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}
LOSS_RTOL = 1e-4
PARAM_ATOL = 1e-4


def _bf16_ulp(x) -> float:
    m = float(np.abs(np.asarray(x, np.float32)).max())
    return 2.0 ** (np.floor(np.log2(m)) - 7) if m > 0 else 0.0


def _data(T, seed, B=3, H=2, dh=16):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(B, T, H, dh).astype(np.float32) for _ in range(3))
    lengths = rng.randint(2, T + 1, size=B)
    lengths[0], lengths[-1] = T, 1  # a full row and a row with one valid key
    mask = (np.arange(T)[None, :] < lengths[:, None])[:, None, None, :]
    bias = (0.3 * rng.randn(1, H, T, T)).astype(np.float32)
    w_out = rng.randn(B, T, H, dh).astype(np.float32)
    return (q, k, v), mask, bias, w_out


@pytest.mark.parametrize("dtype", sorted(DT))
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("T", [16, 37])
def test_backward_matches_pallas_interpret(T, with_bias, dtype):
    tdt, jdt = DT[dtype]
    qkv, mask, bias, w_out = _data(T, T + 2 * with_bias)
    jq = [jnp.asarray(x, jdt) for x in qkv]
    jb = jnp.asarray(bias) if with_bias else None

    def jfn(q, k, v, b):
        out = jax_fused(q, k, v, bias=b, mask=jnp.asarray(mask), interpret=True)
        return jnp.sum(out.astype(jnp.float32) * w_out)

    want = jax.grad(jfn, argnums=(0, 1, 2, 3) if with_bias else (0, 1, 2))(*jq, jb)
    leaves = [torch.tensor(x).to(tdt).requires_grad_() for x in qkv]
    tb = torch.tensor(bias, requires_grad=True) if with_bias else None
    before = (cuda_attention.LAUNCHES_ATTN, cuda_attention.LAUNCHES_ATTN_BWD)
    out = cuda_attention.fused_dot_product_attention(*leaves, bias=tb, mask=torch.tensor(mask))
    (out.float() * torch.tensor(w_out)).sum().backward()
    # CPU tensors: the plain versions, no launch
    assert (cuda_attention.LAUNCHES_ATTN, cuda_attention.LAUNCHES_ATTN_BWD) == before
    got = [x.grad for x in leaves] + ([tb.grad] if with_bias else [])
    for g, jg, name in zip(got, want, ["dq", "dk", "dv", "dbias"]):
        jg = np.asarray(jg, np.float32)
        assert g.shape == jg.shape, name
        if name == "dbias":
            assert g.dtype == torch.float32
            tol = 1e-4 * float(np.abs(jg).max())
        else:
            assert g.dtype == tdt, name
            tol = 2e-5 if dtype == "float32" else _bf16_ulp(jg)
        np.testing.assert_allclose(g.float().numpy(), jg, rtol=0, atol=tol, err_msg=name)


def test_plain_backward_matches_autograd_of_the_forward():
    """mhsa_bwd_reference against autograd through K6's plain version (f32,
    so the two differ in summation order only), the padded core with its
    key mask and bias."""
    rng = np.random.RandomState(3)
    B, Tp, H, dh = 3, 24, 2, 16
    q, k, v = (torch.tensor(rng.randn(B, Tp, H * dh).astype(np.float32)) for _ in range(3))
    bias = torch.tensor((0.3 * rng.randn(H, Tp, Tp)).astype(np.float32))
    kmask = (torch.arange(Tp)[None] < torch.tensor([24, 13, 1])[:, None]).to(torch.int32)[:, None]
    w = torch.tensor(rng.randn(B, Tp, H * dh).astype(np.float32))
    grads = []
    for fn in (cuda_attention.attn_core, cuda_attention.mhsa_fwd_reference):
        leaves = [x.clone().requires_grad_() for x in (q, k, v, bias)]
        (fn(*leaves, kmask, H)[0] * w).sum().backward()
        grads.append([x.grad for x in leaves])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------- trainer


def _batches(n, seed=0):
    examples, vocab = make_synthetic_dataset(num_utts=4 * n, num_phones=6, seed=seed)
    return list(itertools.islice(batch_iterator(examples, 4, 16000, 8, shuffle=False), n)), vocab


@pytest.mark.parametrize("encoder", ["transformer", "conformer"])
def test_three_steps_match_jax_ctc_trainer(encoder, monkeypatch):
    monkeypatch.setenv("UASR_PALLAS_ATTN", "interpret")
    batches, vocab = _batches(3, seed=2)
    kw = dict(encoder=encoder, hidden_size=32, num_heads=2, transformer_layers=2, ffn_dim=64,
              conv_channels=4, attn_pallas=True)
    if encoder == "conformer":
        kw.update(conformer_kernel=7, conformer_rel_clip=8)
    jcfg = JaxConfig(frontend=JaxFrontendConfig(num_mel_bins=16), model=JaxModelConfig(**kw),
                     train=JaxTrainConfig(lr=1e-3, lr_schedule="constant", total_steps=3),
                     vocab_size=len(vocab))
    jtrainer = jax_train.CTCTrainer(jcfg)
    jstate = jtrainer.init_state(jax.random.PRNGKey(0), batches[0])
    rng = np.random.RandomState(4)
    params = jax.tree_util.tree_map_with_path(
        lambda p, x: jnp.asarray((0.3 * rng.randn(*x.shape)).astype(np.float32))
        if "rel_bias" in jax.tree_util.keystr(p) else x, jstate.params)
    jstate = jstate._replace(params=params)
    cfg = tc.Config(frontend=tc.FrontendConfig(num_mel_bins=16), model=tc.ModelConfig(**kw),
                    ctc=tc.CTCConfig(use_pallas=True),
                    train=tc.TrainConfig(lr=1e-3, lr_schedule="constant"), vocab_size=len(vocab))
    trainer = train.CTCTrainer(cfg, device="cpu")
    trainer.model.load_state_dict(flax_to_state_dict(jax.tree.map(np.asarray, params), cfg))
    state = trainer.init_state()
    if encoder == "conformer":
        assert float(state.params["rel_bias0"].detach().abs().min()) > 0
    # flax's key bias adds q_i . b_k to every score of query row i, which the
    # softmax ignores: its gradient is zero but for rounding, and Adam turns
    # each side's rounding into steps of up to ~lr. It is held to that.
    noise = [k for k in state.params if k.endswith("key.bias")]
    _, g0 = trainer.loss_and_grads(state.params, batches[0], trainer.step_generator(0))
    top = max(float(g.abs().max()) for g in g0.values())
    assert noise and all(float(g0[k].abs().max()) <= 1e-6 * top for k in noise)
    start = {k: state.params[k].detach().clone() for k in noise}
    step_fn = jtrainer.jitted_train_step()
    key = jax.random.PRNGKey(1)
    before = (cuda_attention.LAUNCHES_ATTN, cuda_attention.LAUNCHES_ATTN_BWD)
    for b in batches:
        jstate, jaux = step_fn(jstate, JaxBatch(*map(jnp.asarray, b)), key)
        state, aux = trainer.train_step(state, b)
        np.testing.assert_allclose(float(aux["loss"]), float(jaux["loss"]), rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(aux["grad_norm"]), float(jaux["grad_norm"]),
                                   rtol=LOSS_RTOL)
    assert (cuda_attention.LAUNCHES_ATTN, cuda_attention.LAUNCHES_ATTN_BWD) == before
    want = flax_to_state_dict(jax.tree.map(np.asarray, jstate.params), trainer.cfg)
    assert set(want) == set(state.params)
    for k, v in want.items():
        if k in noise:
            for side in (state.params[k].detach(), v):
                assert float((side - start[k]).abs().max()) <= 3 * 3 * 1e-3, k
        else:
            np.testing.assert_allclose(state.params[k].detach().numpy(), v.numpy(),
                                       atol=PARAM_ATOL, rtol=0, err_msg=k)
