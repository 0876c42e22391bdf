"""K6 and K6-bwd, the fused multi-head self-attention forward and backward:
the wrappers of ``csrc/mhsa_fwd.cu`` and ``csrc/mhsa_bwd.cu``, their plain
PyTorch versions, the ``torch.autograd.Function`` that joins them, and
``fused_dot_product_attention``, the counterpart of
``uasr/ops/pallas_attention.py`` (TPU kernels ``_fwd_kernel`` and
``_bwd_kernel`` behind ``_attn_core``'s custom VJP).

``fused_dot_product_attention`` takes flax's layout [B, T, heads, dh]
(a view of the packed [B, T, heads * dh] projection, so no relayout),
pads T to a multiple of 8, turns a key-only mask [B or 1, 1, 1, T] into
[B, 1, Tp] int32 and a batch-shared bias [1, H, T, T] or [H, T, T] into
f32 [H, Tp, Tp], and runs ``attn_core``: K6 forward and K6-bwd backward
for CUDA tensors, their plain versions for CPU tensors. The bias gradient
flows back through the wrapper's pad and f32 cast by autograd, as it does
through the JAX wrapper's. As the JAX wrapper hands active dropout, other
masks and per-example biases to flax, this one hands them to
``ops/attention.py::dot_product_attention``: the JAX package's semantics,
not a fallback on failure. K6 raises on input it does not take.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch
import torch.nn.functional as F

from uasr_torch import _build
from uasr_torch.ops.attention import dot_product_attention

LAUNCHES_ATTN = 0  # K6 launches by mhsa_fwd_cuda (read by chip_smoke.py)
LAUNCHES_ATTN_BWD = 0  # K6-bwd launches by mhsa_bwd_cuda

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128)
NEG = -1e30


def _scale(dh: int) -> float:
    return float(np.float32(1.0 / math.sqrt(dh)))


def mhsa_fwd_reference(q, k, v, bias, kmask, num_heads: int):
    """Plain version of K6. q/k/v [B, Tp, H * dh]; bias [H, Tp, Tp] f32 or
    None; kmask [B, 1, Tp] (> 0 = valid key). Returns (out [B, Tp, H * dh]
    in q's dtype, lse [B, H, Tp] f32): scores in f32 with the scale after
    the product, bias and a -1e30 key mask added, the exact row max, e
    rounded to q's dtype before the product with V and the normalisation
    after it, as the kernel does."""
    B, Tp, D = q.shape
    H = num_heads
    dh = D // H
    f32 = torch.float32

    def heads(x):
        return x.reshape(B, Tp, H, dh).permute(0, 2, 1, 3).to(f32)

    s = (heads(q) @ heads(k).transpose(-1, -2)) * _scale(dh)  # [B, H, Tp, Tp]
    if bias is not None:
        s = s + bias.to(f32)[None]
    madd = torch.where(kmask > 0, 0.0, NEG).to(f32)[:, :, None, :]  # [B, 1, 1, Tp]
    s = s + madd
    m = s.amax(-1, keepdim=True)
    e = torch.exp(s - m)
    ell = e.sum(-1, keepdim=True)
    o = e.to(q.dtype).to(f32) @ heads(v)
    out = (o / ell).to(q.dtype).permute(0, 2, 1, 3).reshape(B, Tp, D)
    return out, (m + torch.log(ell))[..., 0]


def _lib() -> ctypes.CDLL:
    lib = _build.load("mhsa_fwd")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.uasr_mhsa_fwd.argtypes = [P] * 7 + [I] * 4 + [ctypes.c_float, I, P, I]
    lib.uasr_mhsa_fwd.restype = I
    return lib


def _check_attn(what, q, tensors, bias, kmask, num_heads: int) -> None:
    """Raise on input the attention kernels do not take."""
    B, Tp, D = q.shape
    H = num_heads
    dt = q.dtype
    if not q.is_cuda:
        raise ValueError(f"{what} takes CUDA tensors; attn_core runs the plain version on the "
                         "CPU")
    if dt not in _DTYPES:
        raise ValueError(f"{what} takes float32 or bfloat16, got {dt}")
    for t in tensors:
        if t.shape != (B, Tp, D) or t.dtype != dt or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{what}: expected contiguous {dt} {(B, Tp, D)} on {q.device}")
    if D % H or D // H not in _HEAD_DIMS:
        raise ValueError(f"{what} takes a head size in {_HEAD_DIMS}, got {D} / {H}")
    if Tp % 8:
        raise ValueError(f"{what} takes a length padded to a multiple of 8, got {Tp}")
    if kmask.shape != (B, 1, Tp) or kmask.dtype != torch.int32 or kmask.device != q.device:
        raise ValueError(f"{what}: kmask must be int32 [B, 1, Tp] = {(B, 1, Tp)}")
    if bias is not None and (bias.shape != (H, Tp, Tp) or bias.dtype != torch.float32
                             or bias.device != q.device or not bias.is_contiguous()):
        raise ValueError(f"{what}: bias must be contiguous float32 {(H, Tp, Tp)}")
    # the kernels copy 16-byte chunks (cp.async)
    if any(t.data_ptr() % 16 for t in (*tensors, kmask, *([] if bias is None else [bias]))):
        raise ValueError(f"{what}: every tensor must start on a 16-byte boundary")


def mhsa_fwd_cuda(q, k, v, bias, kmask, num_heads: int):
    """Launch K6 on CUDA tensors; same contract as the plain version."""
    global LAUNCHES_ATTN
    B, Tp, D = q.shape
    H = num_heads
    dt = q.dtype
    kmask = kmask.contiguous()
    _check_attn("attention kernel", q, (q, k, v), bias, kmask, H)
    lib = _lib()
    out = torch.empty_like(q)
    lse = torch.empty(B, H, Tp, dtype=torch.float32, device=q.device)
    dev = q.device
    code = lib.uasr_mhsa_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kmask.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(), lse.data_ptr(), B, Tp, H,
        D // H, _scale(D // H), _DTYPES[dt], torch.cuda.current_stream(dev).cuda_stream,
        dev.index if dev.index is not None else torch.cuda.current_device(),
    )
    _build.check(lib, code, "mhsa_fwd kernel")
    LAUNCHES_ATTN += 1
    return out, lse


def mhsa_bwd_reference(q, k, v, bias, kmask, out, lse, dout, num_heads: int):
    """Plain version of K6-bwd (``_bwd_kernel``). K6's inputs, its (out,
    lse) and the cotangent dout [B, Tp, H * dh], cast to q's dtype first.
    Per (b, head), in f32 unless stated: s = q k^T * scale + bias + the
    -1e30 key mask; p = exp(s - lse); dv = (p -> dtype)^T do; dp = do v^T;
    delta = sum(do * o); t = p (dp - delta); tb = (t * scale) -> dtype;
    dq = tb k and dk = tb^T q, each rounded to q's dtype. Returns (dq, dk,
    dv) [B, Tp, H * dh] and d_bias [H, Tp, Tp] f32 (None without a bias),
    the sum of t over the batch in ascending b, the TPU grid's order."""
    B, Tp, D = q.shape
    H = num_heads
    dh = D // H
    dt, f32 = q.dtype, torch.float32
    scale = _scale(dh)

    def heads(x):
        return x.to(dt).reshape(B, Tp, H, dh).permute(0, 2, 1, 3).to(f32)

    qh, kh, vh, oh, doh = (heads(x) for x in (q, k, v, out, dout))
    madd = torch.where(kmask > 0, 0.0, NEG).to(f32)  # [B, 1, Tp]
    grads = [torch.empty(B, H, Tp, dh, dtype=dt, device=q.device) for _ in range(3)]
    dbias = None if bias is None else torch.zeros(H, Tp, Tp, dtype=f32, device=q.device)
    for b in range(B):
        s = (qh[b] @ kh[b].transpose(-1, -2)) * scale  # [H, Tp, Tp]
        if bias is not None:
            s = s + bias.to(f32)
        p = torch.exp((s + madd[b][:, None, :]) - lse[b][..., None])
        grads[2][b] = (p.to(dt).to(f32).transpose(-1, -2) @ doh[b]).to(dt)
        dp = doh[b] @ vh[b].transpose(-1, -2)
        delta = (doh[b] * oh[b]).sum(-1, keepdim=True)
        t = p * (dp - delta)
        if dbias is not None:
            dbias += t
        tb = (t * scale).to(dt).to(f32)
        grads[0][b] = (tb @ kh[b]).to(dt)
        grads[1][b] = (tb.transpose(-1, -2) @ qh[b]).to(dt)
    dq, dk, dv = (g.permute(0, 2, 1, 3).reshape(B, Tp, D) for g in grads)
    return dq, dk, dv, dbias


def _lib_bwd() -> ctypes.CDLL:
    lib = _build.load("mhsa_bwd")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.uasr_mhsa_bwd.argtypes = [P] * 14 + [I] * 4 + [ctypes.c_float, I, P, I]
    lib.uasr_mhsa_bwd.restype = I
    lib.uasr_mhsa_bwd_groups.argtypes = [I] * 3
    lib.uasr_mhsa_bwd_groups.restype = I
    return lib


def mhsa_bwd_cuda(q, k, v, bias, kmask, out, lse, dout, num_heads: int):
    """Launch K6-bwd on CUDA tensors; same contract as the plain version."""
    global LAUNCHES_ATTN_BWD
    B, Tp, D = q.shape
    H = num_heads
    kmask = kmask.contiguous()
    _check_attn("attention backward kernel", q, (q, k, v, out, dout), bias, kmask, H)
    if (lse.shape != (B, H, Tp) or lse.dtype != torch.float32 or not lse.is_contiguous()
            or lse.data_ptr() % 16):
        raise ValueError(f"attention backward kernel: lse must be contiguous float32 "
                         f"{(B, H, Tp)}")
    dev = q.device
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    delta = torch.empty(B, H, Tp, dtype=torch.float32, device=dev)  # sum(do * o) per row
    lib = _lib_bwd()
    dbias = part = None
    if bias is not None:
        # the dq pass's batch groups each sum their rows' d_bias; group 0
        # into dbias, the others into `part`, added in order by the kernel
        groups = lib.uasr_mhsa_bwd_groups(B, Tp, H)
        dbias = torch.empty(H, Tp, Tp, dtype=torch.float32, device=dev)
        if groups > 1:
            part = torch.empty(groups - 1, H, Tp, Tp, dtype=torch.float32, device=dev)
    code = lib.uasr_mhsa_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
        kmask.data_ptr(), lse.data_ptr(), None if bias is None else bias.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        None if dbias is None else dbias.data_ptr(), None if part is None else part.data_ptr(),
        delta.data_ptr(), B, Tp, H, D // H,
        _scale(D // H), _DTYPES[q.dtype], torch.cuda.current_stream(dev).cuda_stream,
        dev.index if dev.index is not None else torch.cuda.current_device(),
    )
    _build.check(lib, code, "mhsa_bwd kernel")
    LAUNCHES_ATTN_BWD += 1
    return dq, dk, dv, dbias


class MHSAttention(torch.autograd.Function):
    """K6 forward, K6-bwd backward (``_attn_core``'s custom VJP): the
    forward saves (q, k, v, bias, kmask, out, lse), as ``_attn_fwd_rule``
    does, and returns (out, lse), lse without a gradient."""

    @staticmethod
    def forward(ctx, q, k, v, bias, kmask, num_heads: int):
        from uasr_torch.ops import library

        out, lse = library.mhsa_fwd(q, k, v, bias, kmask, num_heads)
        ctx.save_for_backward(q, k, v, bias, kmask, out, lse)
        ctx.num_heads = num_heads
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, bias, kmask, out, lse = ctx.saved_tensors
        fn = mhsa_bwd_cuda if dout.is_cuda else mhsa_bwd_reference
        dq, dk, dv, dbias = fn(q, k, v, bias, kmask, out, lse,
                               dout.to(q.dtype).contiguous(), ctx.num_heads)
        return dq, dk, dv, dbias, None, None


def attn_core(q, k, v, bias, kmask, num_heads: int):
    """Padded fused attention (``_attn_core``): (out, lse), K6 for CUDA
    tensors, its plain version for CPU tensors; differentiable through
    ``MHSAttention`` (K6-bwd or its plain version). Without a gradient to
    take, only the operator ``uasr::mhsa_fwd`` runs."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (q, k, v, bias)):
        return MHSAttention.apply(q, k, v, bias, kmask, num_heads)
    from uasr_torch.ops import library

    return library.mhsa_fwd(q, k, v, bias, kmask, num_heads)


def _pad_to(a, axis: int, size: int):
    pad = size - a.shape[axis]
    if pad == 0:
        return a
    widths = [0, 0] * a.ndim
    widths[2 * (a.ndim - 1 - axis) + 1] = pad
    return F.pad(a, widths)


def fused_dot_product_attention(query, key, value, bias=None, mask=None,
                                dropout_rate: float = 0.0, deterministic: bool = True,
                                generator: torch.Generator | None = None):
    """``dot_product_attention`` through K6 (``fused_dot_product_attention``
    of the JAX package). query/key/value [B, T, H, dh], self-attention."""
    def plain():
        return dot_product_attention(query, key, value, bias=bias, mask=mask,
                                     dropout_rate=dropout_rate, deterministic=deterministic,
                                     generator=generator)

    if (dropout_rate > 0.0 and not deterministic) or query.ndim != 4:
        return plain()
    B, T, H, dh = query.shape
    if key.shape != query.shape or value.shape != query.shape:
        return plain()
    # key-only padding masks ([B, 1, 1, T] broadcast) are the only kind the
    # encoders build; anything else goes to the plain attention
    if mask is not None:
        if not (mask.ndim == 4 and mask.shape[1] == 1 and mask.shape[2] == 1
                and mask.shape[0] in (1, B) and mask.shape[3] == T):
            return plain()
        kmask = torch.broadcast_to(mask[:, 0, 0, :], (B, T)).to(torch.int32)
    else:
        kmask = torch.ones(B, T, dtype=torch.int32, device=query.device)
    bias3 = None
    if bias is not None:
        # batch-shared bias only (the conformer's rel-pos bias is [1, H, T, T])
        if bias.ndim == 4 and bias.shape[0] == 1:
            bias3 = bias[0]
        elif bias.ndim == 3:
            bias3 = bias
        else:
            return plain()
        if bias3.shape != (H, T, T):
            return plain()
    Tp = -(-T // 8) * 8
    D = H * dh
    q3, k3, v3 = (_pad_to(x.reshape(B, T, D), 1, Tp) for x in (query, key, value))
    kmask_p = _pad_to(kmask, 1, Tp)[:, None, :].contiguous()
    if bias3 is not None:
        bias3 = _pad_to(_pad_to(bias3.to(torch.float32), 1, Tp), 2, Tp).contiguous()
    out, _ = attn_core(q3.contiguous(), k3.contiguous(), v3.contiguous(), bias3, kmask_p, H)
    return out[:, :T].reshape(B, T, H, dh)
