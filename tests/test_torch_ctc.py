"""CTC loss of the port against the JAX package on the CPU: K3 / K3-bwd's
plain versions (uasr_torch.ops.cuda_ctc) against the Pallas kernels in
interpret mode and the scan loss, the port's scan loss
(uasr_torch.ops.ctc) against JAX's, and one case against
torch.nn.functional.ctc_loss.

Bars are those of tests/test_pallas_ctc.py: loss rtol 1e-4, gradients
atol 2e-4 with rtol 1e-3; the alpha trajectory and d(emit) of the plain
versions against the Pallas kernels' own at atol 1e-4 (both run the same
f32 recursion step for step; only exp/log rounding differs)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from uasr.ops import pallas_ctc
from uasr.ops.ctc import ctc_loss as jax_ctc_loss
from uasr.ops.pallas_ctc import ctc_loss_pallas
from uasr_torch.ops import cuda_ctc
from uasr_torch.ops.ctc import ctc_loss, ctc_loss_mean

LOSS_RTOL = 1e-4
GRAD_TOL = dict(atol=2e-4, rtol=1e-3)


def _problem(B=4, T=20, U=6, V=10, seed=0, blank=0, scale=2.0):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(B, T, V) * scale).astype(np.float32)
    llen = rng.randint(U * 2 + 2, T + 1, size=B).astype(np.int32)
    ulen = rng.randint(1, U + 1, size=B).astype(np.int32)
    nonblank = [v for v in range(V) if v != blank]
    labels = np.asarray(nonblank)[rng.randint(0, V - 1, size=(B, U))].astype(np.int32)
    for b in range(B):
        labels[b, ulen[b]:] = 0
    return logits, llen, labels, ulen


def _edge(case):
    """Edge problems: (logits, logit lengths, labels, label lengths, blank)."""
    logits, llen, labels, ulen = _problem(seed=3)
    blank = 0
    if case == "empty_label":
        ulen[1] = 0
        labels[1] = 0
    elif case == "nonzero_blank":
        blank = 4
        logits, llen, labels, ulen = _problem(seed=4, blank=blank)
    elif case == "uniform_logits":
        logits = np.zeros_like(logits)
    elif case == "repeated_labels":  # skip blocked between equal labels
        labels[0, :4] = [3, 3, 3, 5]
        ulen[0] = max(ulen[0], 4)
        labels[2, :2] = [7, 7]
    elif case == "zero_length_row":  # batch padding: no frames, no labels
        llen[2] = 0
        ulen[2] = 0
        labels[2] = 0
    return logits, llen, labels, ulen, blank


def _torch(*arrays):
    return [torch.tensor(a) for a in arrays]


def _port_loss_and_grad(fn, logits, llen, labels, ulen, blank, w):
    lg = torch.tensor(logits, requires_grad=True)
    per = fn(lg, *_torch(llen, labels, ulen), blank)
    (per * torch.tensor(w)).sum().backward()
    return per.detach().numpy(), lg.grad.numpy()


def _jax_loss_and_grad(fn, logits, llen, labels, ulen, w):
    args = tuple(jnp.asarray(a) for a in (llen, labels, ulen))
    per = fn(jnp.asarray(logits), *args)
    grad = jax.grad(lambda lg: jnp.sum(jnp.asarray(w) * fn(lg, *args)))(jnp.asarray(logits))
    return np.asarray(per), np.asarray(grad)


CASES = ["random", "empty_label", "nonzero_blank", "uniform_logits", "repeated_labels",
         "zero_length_row"]


@pytest.mark.parametrize("case", CASES)
def test_kernel_path_matches_pallas_interpret(case):
    """ctc_loss_kernel on CPU tensors (K3 / K3-bwd's plain versions) against
    ctc_loss_pallas(interpret=True): loss and weighted-cotangent grads."""
    logits, llen, labels, ulen, blank = (_problem() + (0,)) if case == "random" else _edge(case)
    w = np.array([1.0, 0.5, 2.0, -0.3], np.float32)
    per, grad = _port_loss_and_grad(cuda_ctc.ctc_loss_kernel, logits, llen, labels, ulen,
                                    blank, w)
    jfn = lambda *a: ctc_loss_pallas(*a, blank_id=blank, interpret=True)  # noqa: E731
    j_per, j_grad = _jax_loss_and_grad(jfn, logits, llen, labels, ulen, w)
    np.testing.assert_allclose(per, j_per, rtol=LOSS_RTOL, atol=1e-6)
    np.testing.assert_allclose(grad, j_grad, **GRAD_TOL)
    assert np.isfinite(grad).all()
    if case == "uniform_logits":
        # softmax gradient rows sum to zero
        assert np.abs(grad.sum(-1)).max() < 1e-5
    if case == "zero_length_row":
        assert per[2] == 0.0 and not grad[2].any()


@pytest.mark.parametrize("case", ["random", "empty_label", "nonzero_blank", "repeated_labels"])
def test_scan_loss_matches_jax_scan(case):
    """The port's scan-form ctc_loss against uasr.ops.ctc.ctc_loss (which
    the kernel path must agree with too), loss and grads."""
    logits, llen, labels, ulen, blank = (_problem(seed=5) + (0,)) if case == "random" \
        else _edge(case)
    w = np.array([0.7, -1.0, 1.5, 0.25], np.float32)
    per, grad = _port_loss_and_grad(ctc_loss, logits, llen, labels, ulen, blank, w)
    jfn = lambda *a: jax_ctc_loss(*a, blank_id=blank)  # noqa: E731
    j_per, j_grad = _jax_loss_and_grad(jfn, logits, llen, labels, ulen, w)
    np.testing.assert_allclose(per, j_per, rtol=LOSS_RTOL)
    np.testing.assert_allclose(grad, j_grad, **GRAD_TOL)
    k_per, _ = _port_loss_and_grad(cuda_ctc.ctc_loss_kernel, logits, llen, labels, ulen,
                                   blank, w)
    np.testing.assert_allclose(k_per, per, rtol=LOSS_RTOL)
    mean = ctc_loss_mean(*_torch(logits, llen, labels, ulen), blank)
    np.testing.assert_allclose(float(mean), float(np.mean(j_per)), rtol=LOSS_RTOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_recursions_match_pallas_kernels(seed):
    """alpha_traj of K3's plain version and d(emit) of K3-bwd's against the
    Pallas kernels' own outputs (_ctc_fwd / _ctc_bwd_rule, interpret)."""
    logits, llen, labels, ulen = _problem(seed=seed, T=17, U=5)
    llen[1] = 0  # a padding row
    ulen[1] = 0
    labels[1] = 0
    emit, act, skip, svalid, finals = cuda_ctc.ctc_inputs(*_torch(logits, llen, labels, ulen))
    j_in = [jnp.asarray(x.numpy()) for x in (emit, act, skip, svalid, finals)]
    last = jnp.asarray(2 * ulen)
    j_ll, res = pallas_ctc._ctc_fwd(*j_in, last, True)
    traj = cuda_ctc.ctc_alpha_reference(emit, act, skip, svalid)
    np.testing.assert_allclose(traj.numpy(), np.asarray(res[5]), atol=1e-4, rtol=1e-6)
    ll = cuda_ctc.final_ll(traj[-1], finals)
    np.testing.assert_allclose(ll.numpy(), np.asarray(j_ll), rtol=LOSS_RTOL)
    g = np.array([1.0, 3.0, -0.5, 0.2], np.float32)
    j_demit = pallas_ctc._ctc_bwd_rule(True, res, jnp.asarray(g))[0]
    demit = cuda_ctc.ctc_beta_reference(emit, act, skip, finals, traj, ll, torch.tensor(g))
    np.testing.assert_allclose(demit.numpy(), np.asarray(j_demit), atol=1e-4, rtol=1e-4)
    assert not demit[:, 1].any()  # zero-length row: zero posterior


def test_plain_recursions_match_pallas_kernels_on_masks_with_holes():
    """The same on an act mask that is not a prefix, which the TPU kernels
    take: frames dropped inside rows, a row that starts inactive, and the
    zero-length row; label lengths cut so every row stays feasible."""
    logits, llen, labels, ulen = _problem(seed=2, T=23, U=5)
    llen[1] = 0  # a padding row
    rng = np.random.RandomState(11)
    T = logits.shape[1]
    act = (np.arange(T)[:, None] < llen[None, :]) & (rng.rand(T, len(llen)) > 0.2)
    act[:4, 0] = False  # row 0 starts inactive
    act[10:13, 2] = False  # a run of holes inside row 2
    ulen = np.minimum(ulen, np.maximum(act.sum(0) - 1, 0) // 2).astype(np.int32)
    labels[np.arange(labels.shape[1])[None] >= ulen[:, None]] = 0
    emit, _, skip, svalid, finals = cuda_ctc.ctc_inputs(*_torch(logits, llen, labels, ulen))
    act = torch.tensor(act, dtype=torch.float32)
    j_in = [jnp.asarray(x.numpy()) for x in (emit, act, skip, svalid, finals)]
    j_ll, res = pallas_ctc._ctc_fwd(*j_in, jnp.asarray(2 * ulen), True)
    traj = cuda_ctc.ctc_alpha_reference(emit, act, skip, svalid)
    np.testing.assert_allclose(traj.numpy(), np.asarray(res[5]), atol=1e-4, rtol=1e-6)
    assert torch.equal(traj[:4, 0], traj[:1, 0].expand(4, -1))  # inactive steps carry alpha
    ll = cuda_ctc.final_ll(traj[-1], finals)
    np.testing.assert_allclose(ll.numpy(), np.asarray(j_ll), rtol=LOSS_RTOL)
    assert (ll.numpy()[ulen > 0] > -1e3).all()  # every row feasible
    g = np.array([1.0, 3.0, -0.5, 0.2], np.float32)
    j_demit = pallas_ctc._ctc_bwd_rule(True, res, jnp.asarray(g))[0]
    demit = cuda_ctc.ctc_beta_reference(emit, act, skip, finals, traj, ll, torch.tensor(g))
    np.testing.assert_allclose(demit.numpy(), np.asarray(j_demit), atol=1e-4, rtol=1e-4)
    assert not demit[act == 0].any()  # inactive steps: zero posterior


def test_kernel_path_matches_torch_ctc_loss():
    logits, llen, labels, ulen = _problem(seed=7)
    lg = torch.tensor(logits, requires_grad=True)
    per = cuda_ctc.ctc_loss_kernel(lg, *_torch(llen, labels, ulen))
    per.sum().backward()
    lg2 = torch.tensor(logits, requires_grad=True)
    ref = torch.nn.functional.ctc_loss(
        torch.log_softmax(lg2, -1).transpose(0, 1), torch.tensor(labels).long(),
        torch.tensor(llen).long(), torch.tensor(ulen).long(), blank=0, reduction="none")
    ref.sum().backward()
    np.testing.assert_allclose(per.detach().numpy(), ref.detach().numpy(), rtol=LOSS_RTOL)
    np.testing.assert_allclose(lg.grad.numpy(), lg2.grad.numpy(), **GRAD_TOL)


def test_cpu_tensors_run_plain_versions():
    logits, llen, labels, ulen = _problem(seed=8)
    before = (cuda_ctc.LAUNCHES, cuda_ctc.LAUNCHES_BWD)
    lg = torch.tensor(logits, requires_grad=True)
    cuda_ctc.ctc_loss_kernel(lg, *_torch(llen, labels, ulen)).sum().backward()
    assert (cuda_ctc.LAUNCHES, cuda_ctc.LAUNCHES_BWD) == before
