"""K3 and K3-bwd, the CTC forward-backward recursion: wrappers of
``csrc/ctc_alpha.cu`` and ``csrc/ctc_beta.cu``, their plain PyTorch
versions, and the loss built on them (the ``ctc.use_pallas: true`` path).

Counterpart of ``uasr/ops/pallas_ctc.py``. The label-dependent structure
(blank-interleaved sequence, skip, valid-state and final-state masks as
additive [B, S] terms), the log-softmax and the emit gather stay torch
ops, as they stay XLA ops in the JAX package; the autograd engine
differentiates the gather (a scatter into logp) and the log-softmax. The
recursion itself is one ``torch.autograd.Function``: its forward is K3
(alpha trajectory, then ll), its backward is K3-bwd (beta and the
posterior, written directly as d(emit)).

Each ``*_cuda`` wrapper launches its kernel for CUDA tensors and raises on
input the kernel does not take; ``ctc_alpha`` / ``ctc_beta`` run the plain
version only for CPU tensors. The kernels bring each step's rows into a
ring of ``depth`` slots in shared memory, ``depth`` - 1 steps ahead of the
chain (``RING_DEPTH`` unless the caller asks for 2, 4 or 8; halved while
the ring does not fit shared memory); ``LAST_ALPHA_PLAN`` /
``LAST_BETA_PLAN`` are the last launch's (threads, ring depth).
``ctc_alpha_phases`` / ``ctc_beta_phases`` run the kernels' builds with
phase stamps (``uasr_torch.tools.time_ctc`` reads them).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from uasr_torch import _build
from uasr_torch.ops.ctc import LOG_EPSILON, extended_labels, skip_allowed

NEG = LOG_EPSILON  # finite -inf
MAX_STATES = 8192  # the kernels take S = 2U + 1 up to 8 states per thread x 1024

LAUNCHES = 0  # K3 launches by ctc_alpha_cuda (read by chip_smoke.py)
LAUNCHES_BWD = 0  # K3-bwd launches by ctc_beta_cuda
RING_DEPTH = 16  # the ring's slots (the fastest of 4, 8, 16 at both training shapes)
LAST_ALPHA_PLAN = None  # (threads, ring depth) of the last K3 launch
LAST_BETA_PLAN = None  # the same for K3-bwd
LAUNCHES_PHASES = 0  # launches of the stamped builds by ctc_alpha_phases / ctc_beta_phases
# the phases the stamped builds time, in the order of their columns
PHASE_NAMES = ("rows", "math", "barrier", "stores")


def _lse3(a, b, c):
    m = torch.clamp(torch.maximum(torch.maximum(a, b), c), min=NEG)
    return m + torch.log(torch.exp(a - m) + torch.exp(b - m) + torch.exp(c - m))


def _shift_right(x, k):
    """x[s - k], NEG shifted in at the low end."""
    return F.pad(x, (k, 0), value=NEG)[:, : x.shape[1]]


def _shift_left(x, k):
    """x[s + k], NEG shifted in at the high end."""
    return F.pad(x, (0, k), value=NEG)[:, k:]


def ctc_alpha_reference(emit, act, skip_neg, svalid_neg):
    """Plain version of K3, step for step: alpha_traj [T, B, S] f32 from
    the virtual seed alpha_{-1} = [0, NEG, ...]."""
    T, B, S = emit.shape
    col = torch.arange(S, device=emit.device)
    alpha = torch.where(col == 0, 0.0, NEG).to(torch.float32).expand(B, S)
    traj = []
    for t in range(T):
        a1 = _shift_right(alpha, 1)
        a2 = _shift_right(alpha, 2) + skip_neg
        new = _lse3(alpha, a1, a2) + emit[t]
        new = torch.clamp(new + svalid_neg, min=NEG)
        mf = act[t][:, None]
        alpha = mf * new + (1.0 - mf) * alpha
        traj.append(alpha)
    return torch.stack(traj)


def ctc_beta_reference(emit, act, skip_neg, finals_neg, alpha_traj, ll, g):
    """Plain version of K3-bwd, step for step: demit [T, B, S] f32, the
    posterior exp(alpha + beta - ll) times the cotangent g, zero on
    inactive steps."""
    T, B, S = emit.shape
    beta = finals_neg
    out = [None] * T
    for t in reversed(range(T)):
        if t < T - 1:
            be = beta + emit[t + 1]
            new = _lse3(be, _shift_left(be, 1), _shift_left(be + skip_neg, 2))
            mf = act[t + 1][:, None]
            beta = mf * torch.clamp(new, min=NEG) + (1.0 - mf) * beta
        gam = torch.exp(torch.clamp(alpha_traj[t] + beta, min=2.0 * NEG) - ll[:, None])
        out[t] = gam * act[t][:, None] * g[:, None]
    return torch.stack(out)


def _check(name, tensors, device):
    for t, shape in tensors:
        if (t.shape != shape or t.dtype != torch.float32 or t.device != device
                or not t.is_contiguous()):
            raise ValueError(f"{name}: expected contiguous float32 {shape} on {device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _lib(name: str, nptr: int) -> ctypes.CDLL:
    lib = _build.load(name)
    P, I = ctypes.c_void_p, ctypes.c_int
    getattr(lib, f"uasr_{name}").argtypes = [P] * nptr + [I, I, I, I, P, I]
    getattr(lib, f"uasr_{name}_phases").argtypes = [P] * nptr + [I, I, I, I, P, P, I]
    getattr(lib, f"uasr_{name}_plan").argtypes = [I, I, I, P, P]
    for fn in ("", "_phases", "_plan"):
        getattr(lib, f"uasr_{name}{fn}").restype = I
    return lib


@functools.lru_cache(maxsize=None)
def _plan(name: str, S: int, depth: int, device: int) -> tuple[int, int]:
    """The kernel's launch plan: (threads per CTA, ring depth)."""
    lib = _build.load(name)
    threads, d = ctypes.c_int(), ctypes.c_int()
    code = getattr(lib, f"uasr_{name}_plan")(S, depth, device, ctypes.byref(threads),
                                              ctypes.byref(d))
    _build.check(lib, code, f"{name} plan")
    return threads.value, d.value


def _check_depth(depth):
    if depth not in (2, 4, 8, 16):
        raise ValueError(f"ring depth must be 2, 4, 8 or 16, got {depth}")


def _launch_args(emit):
    dev = emit.device
    return (torch.cuda.current_stream(dev).cuda_stream,
            dev.index if dev.index is not None else torch.cuda.current_device())


def _alpha(emit, act, skip_neg, svalid_neg, depth, phases):
    global LAST_ALPHA_PLAN
    T, B, S = emit.shape
    _check_depth(depth)
    _check("ctc_alpha kernel", ((emit, (T, B, S)), (act, (T, B)), (skip_neg, (B, S)),
                                (svalid_neg, (B, S))), emit.device)
    if S > MAX_STATES:
        raise ValueError(f"ctc_alpha kernel takes S <= {MAX_STATES} states, got {S}")
    traj = torch.empty_like(emit)
    lib = _lib("ctc_alpha", 5)
    args = (emit.data_ptr(), act.data_ptr(), skip_neg.data_ptr(), svalid_neg.data_ptr(),
            traj.data_ptr(), T, B, S, depth)
    stream, device = _launch_args(emit)
    if phases is None:
        code = lib.uasr_ctc_alpha(*args, stream, device)
    else:
        code = lib.uasr_ctc_alpha_phases(*args, phases.data_ptr(), stream, device)
    _build.check(lib, code, "ctc_alpha kernel")
    LAST_ALPHA_PLAN = _plan("ctc_alpha", S, depth, device)
    return traj


def _beta(emit, act, skip_neg, finals_neg, alpha_traj, ll, g, depth, phases):
    global LAST_BETA_PLAN
    T, B, S = emit.shape
    _check_depth(depth)
    _check("ctc_beta kernel", ((emit, (T, B, S)), (act, (T, B)), (skip_neg, (B, S)),
                               (finals_neg, (B, S)), (alpha_traj, (T, B, S)), (ll, (B,)),
                               (g, (B,))), emit.device)
    if S > MAX_STATES:
        raise ValueError(f"ctc_beta kernel takes S <= {MAX_STATES} states, got {S}")
    demit = torch.empty_like(emit)
    lib = _lib("ctc_beta", 8)
    args = (emit.data_ptr(), act.data_ptr(), skip_neg.data_ptr(), finals_neg.data_ptr(),
            alpha_traj.data_ptr(), ll.data_ptr(), g.data_ptr(), demit.data_ptr(), T, B, S,
            depth)
    stream, device = _launch_args(emit)
    if phases is None:
        code = lib.uasr_ctc_beta(*args, stream, device)
    else:
        code = lib.uasr_ctc_beta_phases(*args, phases.data_ptr(), stream, device)
    _build.check(lib, code, "ctc_beta kernel")
    LAST_BETA_PLAN = _plan("ctc_beta", S, depth, device)
    return demit


def _phases(emit):
    return torch.zeros(emit.shape[1], len(PHASE_NAMES), dtype=torch.int64, device=emit.device)


def ctc_alpha_cuda(emit, act, skip_neg, svalid_neg, depth: int = RING_DEPTH):
    """Launch K3 on CUDA tensors; same contract as the plain version."""
    global LAUNCHES
    traj = _alpha(emit, act, skip_neg, svalid_neg, depth, None)
    LAUNCHES += 1
    return traj


def ctc_beta_cuda(emit, act, skip_neg, finals_neg, alpha_traj, ll, g, depth: int = RING_DEPTH):
    """Launch K3-bwd on CUDA tensors; same contract as the plain version."""
    global LAUNCHES_BWD
    demit = _beta(emit, act, skip_neg, finals_neg, alpha_traj, ll, g, depth, None)
    LAUNCHES_BWD += 1
    return demit


def ctc_alpha_phases(emit, act, skip_neg, svalid_neg, depth: int = RING_DEPTH):
    """K3 built with its phase stamps (a diagnostic; no training path calls
    it): ``ctc_alpha_cuda``'s output, and [B, len(PHASE_NAMES)] int64 clock
    cycles that each CTA's thread 0 spent in each phase, summed over the
    steps."""
    global LAUNCHES_PHASES
    phases = _phases(emit)
    traj = _alpha(emit, act, skip_neg, svalid_neg, depth, phases)
    LAUNCHES_PHASES += 1
    return traj, phases


def ctc_beta_phases(emit, act, skip_neg, finals_neg, alpha_traj, ll, g, depth: int = RING_DEPTH):
    """K3-bwd built with its phase stamps, as ``ctc_alpha_phases``."""
    global LAUNCHES_PHASES
    phases = _phases(emit)
    demit = _beta(emit, act, skip_neg, finals_neg, alpha_traj, ll, g, depth, phases)
    LAUNCHES_PHASES += 1
    return demit, phases


def ctc_alpha(emit, act, skip_neg, svalid_neg):
    """K3 for CUDA tensors, its plain version for CPU tensors."""
    fn = ctc_alpha_cuda if emit.is_cuda else ctc_alpha_reference
    return fn(emit, act, skip_neg, svalid_neg)


def ctc_beta(emit, act, skip_neg, finals_neg, alpha_traj, ll, g):
    """K3-bwd for CUDA tensors, its plain version for CPU tensors."""
    fn = ctc_beta_cuda if emit.is_cuda else ctc_beta_reference
    return fn(emit, act, skip_neg, finals_neg, alpha_traj, ll, g)


def final_ll(alpha_last, finals_neg):
    """Log likelihood [B] from the last alpha row and the final-state mask."""
    final = alpha_last + finals_neg
    m = torch.clamp(final.max(dim=1).values, min=NEG)
    return m + torch.log(torch.exp(final - m[:, None]).sum(dim=1))


class CTCLogLikelihood(torch.autograd.Function):
    """ll [B] of the recursion over emit [T, B, S]: forward K3, backward
    K3-bwd (``_ctc_ll`` with its custom VJP in the JAX package)."""

    @staticmethod
    def forward(ctx, emit, act, skip_neg, svalid_neg, finals_neg):
        alpha_traj = ctc_alpha(emit, act, skip_neg, svalid_neg)
        ll = final_ll(alpha_traj[-1], finals_neg)
        ctx.save_for_backward(emit, act, skip_neg, finals_neg, alpha_traj, ll)
        return ll

    @staticmethod
    def backward(ctx, g):
        emit, act, skip_neg, finals_neg, alpha_traj, ll = ctx.saved_tensors
        demit = ctc_beta(emit, act, skip_neg, finals_neg, alpha_traj, ll,
                         g.to(torch.float32).contiguous())
        return demit, None, None, None, None


def ctc_inputs(logits, logit_lengths, labels, label_lengths, blank_id: int = 0):
    """The recursion's inputs, as ``ctc_loss_pallas`` builds them: emit
    [T, B, S] f32 (differentiable in logits), act [T, B] and the additive
    masks skip_neg, svalid_neg, finals_neg [B, S]."""
    B, T, V = logits.shape
    S = 2 * labels.shape[1] + 1
    dev = logits.device
    logp = torch.log_softmax(logits, dim=-1)
    z = extended_labels(labels.to(dev), blank_id)
    f32 = torch.float32
    skip_neg = torch.where(skip_allowed(z, blank_id), 0.0, NEG).to(f32)
    label_lengths = label_lengths.to(dev)
    s_idx = torch.arange(S, device=dev)[None, :]
    svalid_neg = torch.where(s_idx < (2 * label_lengths + 1)[:, None], 0.0, NEG).to(f32)
    last = (2 * label_lengths)[:, None]
    finals = (s_idx == last) | ((s_idx == last - 1) & (label_lengths[:, None] > 0))
    finals_neg = torch.where(finals, 0.0, NEG).to(f32)
    emit = torch.gather(logp, 2, z[:, None, :].expand(B, T, S))
    emit = emit.transpose(0, 1).to(f32).contiguous()  # [T, B, S]
    act = (torch.arange(T, device=dev)[:, None] < logit_lengths.to(dev)[None, :]).to(f32)
    return emit, act, skip_neg, svalid_neg, finals_neg


def ctc_loss_kernel(logits, logit_lengths, labels, label_lengths, blank_id: int = 0):
    """Per-utterance negative log likelihood [B] through K3 / K3-bwd
    (``ctc_loss_pallas``); zero-length rows give 0 and no gradient."""
    emit, act, skip_neg, svalid_neg, finals_neg = ctc_inputs(
        logits, logit_lengths, labels, label_lengths, blank_id)
    return -CTCLogLikelihood.apply(emit, act, skip_neg, svalid_neg, finals_neg)
