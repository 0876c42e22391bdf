"""K2 and K2-bwd, the two-stream BiGRU recurrence and its backward, and K5,
K5-bwd and K8, the grouped GRU recurrence and its two backwards: wrappers of
``csrc/bigru_fwd.cu``, ``csrc/bigru_bwd.cu``, ``csrc/gru_fwd.cu``,
``csrc/gru_bwd.cu`` and ``csrc/gru_bwd_lin.cu``, their plain PyTorch
versions, and the ``torch.autograd.Function``s that join each forward to
its backward. The forwards go through the operators ``uasr::bigru_scan``
and ``uasr::gru_scan`` (``ops/library.py``).

Counterpart of ``uasr/models/pallas_gru.py::pallas_bigru_scan`` (TPU
kernels ``_fwd2_kernel`` and ``_bwd2_kernel`` with the custom VJP
``_fwd2_rule`` / ``_bwd2_rule``). ``bigru_scan`` is differentiable: its
forward launches K2 and its backward K2-bwd for CUDA tensors, and both
run their plain versions for CPU tensors. K2 is K5 with two groups, group
1 in reversed frames: K5's kernel, reading p0 / p1 and writing its output
in place. K2-bwd is K5-bwd's backward with two groups in the same way:
the same coefficient kernel (``bigru_bwd_coeffs_cuda``) and reverse chain
(``bigru_bwd_chain_cuda``). The weight gradients dwh and dbh are
whole-trajectory products outside the kernel, as in the JAX package.

``gru_scan`` is the counterpart of ``pallas_gru_scan`` (TPU kernels
``_fwd_kernel``, ``_bwd_kernel`` and ``_bwd_lin_kernel`` with the custom
VJP ``_fwd_rule`` / ``_bwd_rule``), differentiable through ``GRUScan``.
Its backward follows ``BWD_IMPL``, read from ``UASR_GRU_BWD_IMPL`` as the
JAX module reads it: ``fused`` (default) recomputes the gates (K5-bwd:
a coefficient kernel, ``gru_bwd_coeffs_cuda``, then the reverse chain);
``linear`` has the forward emit per-step coefficients (K5 with
``save_coeffs``) and runs the slim reverse chain (K8).
"""

from __future__ import annotations

import ctypes
import os

import torch

from uasr_torch import _build

LAUNCHES = 0  # K2 launches by bigru_scan_cuda (read by chip_smoke.py)
LAUNCHES_BWD = 0  # K2-bwd (reverse chain) launches by bigru_bwd_chain_cuda
LAUNCHES_BWD_COEFFS = 0  # K2-bwd coefficient-kernel launches by bigru_bwd_coeffs_cuda
LAUNCHES_GRU = 0  # K5 launches by gru_scan_cuda
LAUNCHES_GRU_BWD = 0  # K5-bwd (reverse chain) launches by gru_scan_bwd_cuda
LAUNCHES_GRU_COEFFS = 0  # K5-bwd coefficient-kernel launches by gru_bwd_coeffs_cuda
LAUNCHES_GRU_LIN = 0  # K8 launches by gru_scan_bwd_lin_cuda
LAST_BIGRU_PLAN = None  # (hidden units per CTA, batch splits) of the last K2 launch
LAST_BIGRU_WH = None  # "resident" or "streamed": wh in shared memory in that launch
LAST_BIGRU_BWD_PLAN = None  # (hidden units per CTA, batch splits) of the last K2-bwd chain
LAST_BIGRU_BWD_WH = None  # "resident" or "streamed": wh in shared memory in that launch
LAST_GRU_PLAN = None  # (hidden units per CTA, batch splits) of the last K5 launch
LAST_GRU_BWD_PLAN = None  # the same of the last K5-bwd or K8 launch
LAST_GRU_WH = None  # "resident" or "streamed": wh in shared memory in the last K5 launch
LAST_GRU_BWD_WH = None  # the same of the last K5-bwd or K8 launch

# backward of gru_scan: "linear" = K5 with save_coeffs + K8, else K5-bwd
# (pallas_gru.py::BWD_IMPL, the same variable)
BWD_IMPL = os.environ.get("UASR_GRU_BWD_IMPL", "fused")

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_GRU_BAR_GROUPS = 256  # barriers a persistent grid may use: one per group and batch split
_GRU_MAX_UNITS = 64  # hidden units of the widest CTA of K2, K2-bwd, K5, K5-bwd, K8 (MAX_UNITS)
_WH = ("resident", "streamed")


def bigru_scan_reference(p0, p1, wh, bh, tmask):
    """Plain version of K2, step for step.

    p0/p1: [T, B, 3H] input projections (bias added) of the forward and
    the reversed direction, both in frame order; wh [2, H, 3H];
    bh [2, 3H]; tmask [T, 2, B] in kernel time (stream 1 reads frame
    T-1-u at step u). Returns [T, B, 2H] in p0's dtype: forward states,
    then reversed states in frame order. Gates run in f32; the carry is
    rounded to the output dtype every step, as the kernel does.
    """
    T, B, H3 = p0.shape
    H = H3 // 3
    mask = tmask.to(torch.float32)[..., None]  # [T, 2, B, 1]
    xp_all = torch.stack([p0, p1.flip(0)], 1)  # [T, 2, B, 3H] kernel time
    w = wh.to(torch.float32)
    bias = bh.to(torch.float32)[:, None, :]
    h = torch.zeros(2, B, H, dtype=torch.float32, device=p0.device)
    ys = []
    for u in range(T):
        hp = torch.bmm(h.to(wh.dtype).to(torch.float32), w) + bias
        xp = xp_all[u].to(torch.float32)
        xr, xz, xn = xp.split(H, -1)
        hr, hz, hn = hp.split(H, -1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        h_cand = (1.0 - z) * n + z * h
        mf = mask[u]
        h_store = (mf * h_cand + (1.0 - mf) * h).to(p0.dtype)
        ys.append(h_store)
        h = h_store.to(torch.float32)
    ys = torch.stack(ys)  # [T, 2, B, H]
    return torch.cat([ys[:, 0], ys[:, 1].flip(0)], -1)


def _lib() -> ctypes.CDLL:
    lib = _build.load("bigru_fwd")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.uasr_bigru_fwd.argtypes = [P] * 7 + [I] * 5 + [P, I, P, P, P]
    lib.uasr_bigru_fwd.restype = I
    return lib


def _check_bigru(what, H, tensors):
    """K2's and K2-bwd's wrappers take CUDA tensors of K2's dtypes and
    shapes, on a 16-byte boundary, at a hidden size whose two directions'
    grids fit."""
    t0 = tensors[0][0]
    if not t0.is_cuda:
        raise ValueError(f"{what} takes CUDA tensors; BiGRUScan runs the plain version on the "
                         f"CPU")
    _check_gru(what, t0.dtype, H, 2, tensors)
    if any(t.data_ptr() % 16 for t, _, _ in tensors):
        raise ValueError(f"{what}: tensors must start on a 16-byte boundary")
    _check_grid(what, 2, H, t0.device)


def bigru_scan_cuda(p0, p1, wh, bh, tmask):
    """Launch K2 on CUDA tensors; same contract as the plain version."""
    global LAUNCHES, LAST_BIGRU_PLAN, LAST_BIGRU_WH
    T, B, H3 = p0.shape
    H = H3 // 3
    dt = p0.dtype
    _check_bigru("bigru kernel", H, [(p0, (T, B, H3), dt), (p1, (T, B, H3), dt),
                                     (wh, (2, H, H3), dt), (bh, (2, H3), dt)])
    if tmask.shape != (T, 2, B):
        raise ValueError(f"bigru kernel: tmask must be [T, 2, B], got {tuple(tmask.shape)}")
    dev = p0.device
    mask = tmask.to(device=dev, dtype=torch.float32).contiguous()
    out = torch.empty(T, B, 2 * H, dtype=dt, device=dev)
    bar = torch.zeros(2 * 32 * _GRU_BAR_GROUPS, dtype=torch.int32, device=dev)
    units, splits, streamed = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    lib = _lib()
    code = lib.uasr_bigru_fwd(
        p0.data_ptr(), p1.data_ptr(), wh.data_ptr(), bh.data_ptr(), mask.data_ptr(),
        out.data_ptr(), bar.data_ptr(), _GRU_BAR_GROUPS, T, B, H, _DTYPES[dt],
        *_launch_args(dev), ctypes.byref(units), ctypes.byref(splits), ctypes.byref(streamed),
    )
    _build.check(lib, code, "bigru_fwd kernel")
    LAUNCHES += 1
    LAST_BIGRU_PLAN = (units.value, splits.value)
    LAST_BIGRU_WH = _WH[streamed.value]
    return out


def _prev_states(out):
    """h_prev trajectories in frame order: stream 0's at frame u is
    ys0[u-1], stream 1's at frame f is ys1[f+1] (zero at the ends)."""
    H = out.shape[-1] // 2
    ys0, ys1 = out[..., :H], out[..., H:]
    z1 = torch.zeros_like(ys0[:1])
    return torch.cat([z1, ys0[:-1]]), torch.cat([ys1[1:], z1])


def bigru_scan_bwd_reference(p0, p1, wh, bh, tmask, out, dout):
    """Plain version of K2-bwd, step for step.

    Same inputs as K2 plus its output ``out`` and the cotangent ``dout``
    [T, B, 2H]. Returns (dxp0, dxp1, dhn0, dhn1) in frame order and p0's
    dtype: d of the input projections [T, B, 3H] and of the n block of
    h_prev @ wh [T, B, H]. Phase 1 recomputes the gates from h_prev (read
    in the stored dtype) into per-step coefficients; phase 2 runs the
    reverse chain with dh carried in f32 and dhproj rounded to wh's dtype
    before its product, as the kernel does.
    """
    T, B, H3 = p0.shape
    H = H3 // 3
    f32 = torch.float32
    w = wh.to(f32)
    bias = bh.to(f32)
    outs = []
    for g, (p, h) in enumerate(zip((p0, p1), _prev_states(out))):
        # phase 1 in frame order; stream 1's frame f is kernel step T-1-f
        mf = (tmask[:, g] if g == 0 else tmask[:, g].flip(0)).to(f32)[..., None]
        h_prev = h.to(f32)
        hp = h_prev @ w[g] + bias[g]
        xr, xz, xn = p.to(f32).split(H, -1)
        hr, hz, hn = hp.split(H, -1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        c_n2 = mf * ((1.0 - z) * (1.0 - n * n))
        c_r = c_n2 * (hn * (r * (1.0 - r)))
        c_z = mf * ((h_prev - n) * (z * (1.0 - z)))
        c_nh = c_n2 * r
        ch = (1.0 - mf) + mf * z
        # phase 2: kernel steps u = T-1 .. 0
        dy = dout[..., g * H:(g + 1) * H]
        w_t = w[g].T
        dh = torch.zeros(B, H, dtype=f32, device=p0.device)
        dxp = torch.empty(T, B, H3, dtype=p0.dtype, device=p0.device)
        dhn = torch.empty(T, B, H, dtype=p0.dtype, device=p0.device)
        for u in reversed(range(T)):
            f = u if g == 0 else T - 1 - u
            d = dh + dy[f].to(f32)
            e_r, e_z, e_n, e_nh = c_r[f] * d, c_z[f] * d, c_n2[f] * d, c_nh[f] * d
            dxp[f] = torch.cat([e_r, e_z, e_n], -1).to(p0.dtype)
            dhn[f] = e_nh.to(p0.dtype)
            dhproj = torch.cat([e_r, e_z, e_nh], -1).to(wh.dtype).to(f32)
            dh = ch[f] * d + dhproj @ w_t
        outs.append((dxp, dhn))
    (dxp0, dhn0), (dxp1, dhn1) = outs
    return dxp0, dxp1, dhn0, dhn1


def _kernel_time(a0, a1):
    """Two frame-ordered [T, B, W] tensors of the two streams as one
    [T, 2, B, W] in kernel time (stream 1's step u is frame T-1-u): the
    rows K2-bwd's layout addresses in place, for the plain versions."""
    return torch.stack([a0, a1.flip(0)], 1)


def bigru_bwd_coeffs_reference(p0, p1, wh, bh, tmask, out):
    """Plain version of K2-bwd's coefficient kernel: K5-bwd's
    (``gru_bwd_coeffs_reference``) on K2's inputs in kernel time, so stream
    1's h_prev at step u is ``out``'s frame T-u. Returns c4 [T, 2, B, 4H]
    and ch [T, 2, B, H], f32, in kernel time."""
    H = out.shape[-1] // 2
    return gru_bwd_coeffs_reference(_kernel_time(p0, p1), wh, bh, tmask,
                                    _kernel_time(out[..., :H], out[..., H:]))


def _lib_bwd() -> ctypes.CDLL:
    lib = _build.load("bigru_bwd")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.uasr_bigru_bwd_coeffs.argtypes = [P] * 8 + [I] * 4 + [P, I]
    lib.uasr_bigru_bwd_coeffs.restype = I
    lib.uasr_bigru_bwd.argtypes = [P] * 11 + [I] * 5 + [P, I, P, P, P]
    lib.uasr_bigru_bwd.restype = I
    return lib


def bigru_bwd_coeffs_cuda(p0, p1, wh, bh, tmask, out):
    """Launch K2-bwd's coefficient kernel on CUDA tensors; same contract as
    ``bigru_bwd_coeffs_reference``."""
    global LAUNCHES_BWD_COEFFS
    T, B, H3 = p0.shape
    H = H3 // 3
    dt = p0.dtype
    _check_bigru("bigru backward coefficient kernel", H,
                 [(p0, (T, B, H3), dt), (p1, (T, B, H3), dt), (wh, (2, H, H3), dt),
                  (bh, (2, H3), dt), (out, (T, B, 2 * H), dt)])
    if tmask.shape != (T, 2, B):
        raise ValueError(f"bigru backward coefficient kernel: tmask must be [T, 2, B], got "
                         f"{tuple(tmask.shape)}")
    dev = p0.device
    f32 = torch.float32
    mask = tmask.to(device=dev, dtype=f32).contiguous()
    c4 = torch.empty(T, 2, B, 4 * H, dtype=f32, device=dev)
    ch = torch.empty(T, 2, B, H, dtype=f32, device=dev)
    lib = _lib_bwd()
    code = lib.uasr_bigru_bwd_coeffs(
        p0.data_ptr(), p1.data_ptr(), wh.data_ptr(), bh.data_ptr(), mask.data_ptr(),
        out.data_ptr(), c4.data_ptr(), ch.data_ptr(), T, B, H, _DTYPES[dt], *_launch_args(dev),
    )
    _build.check(lib, code, "bigru_bwd coefficient kernel")
    LAUNCHES_BWD_COEFFS += 1
    return c4, ch


def bigru_bwd_chain_cuda(c4, ch, wh, dout):
    """Launch K2-bwd's reverse chain on CUDA tensors from the coefficient
    kernel's c4 [T, 2, B, 4H] and ch [T, 2, B, H] (f32, kernel time).
    Returns (dxp0, dxp1, dhn0, dhn1) in frame order and dout's dtype."""
    global LAUNCHES_BWD, LAST_BIGRU_BWD_PLAN, LAST_BIGRU_BWD_WH
    T, B, H2 = dout.shape
    H = H2 // 2
    dt = dout.dtype
    f32 = torch.float32
    _check_bigru("bigru backward kernel", H,
                 [(wh, (2, H, 3 * H), dt), (dout, (T, B, 2 * H), dt),
                  (c4, (T, 2, B, 4 * H), f32), (ch, (T, 2, B, H), f32)])
    dev = dout.device
    dxp0, dxp1 = (torch.empty(T, B, 3 * H, dtype=dt, device=dev) for _ in range(2))
    dhn0, dhn1 = (torch.empty(T, B, H, dtype=dt, device=dev) for _ in range(2))
    chd = torch.empty(2, B, H, dtype=f32, device=dev)  # ch * d carried to the next step
    xch = torch.empty(2, 2, B, 3 * H, dtype=dt, device=dev)  # per-step exchange rows
    bar = torch.zeros(2 * 32 * _GRU_BAR_GROUPS, dtype=torch.int32, device=dev)
    units, splits, streamed = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    lib = _lib_bwd()
    code = lib.uasr_bigru_bwd(
        c4.data_ptr(), ch.data_ptr(), dout.data_ptr(), wh.data_ptr(), dxp0.data_ptr(),
        dxp1.data_ptr(), dhn0.data_ptr(), dhn1.data_ptr(), chd.data_ptr(), xch.data_ptr(),
        bar.data_ptr(), _GRU_BAR_GROUPS, T, B, H, _DTYPES[dt], *_launch_args(dev),
        ctypes.byref(units), ctypes.byref(splits), ctypes.byref(streamed),
    )
    _build.check(lib, code, "bigru_bwd kernel")
    LAUNCHES_BWD += 1
    LAST_BIGRU_BWD_PLAN = (units.value, splits.value)
    LAST_BIGRU_BWD_WH = _WH[streamed.value]
    return dxp0, dxp1, dhn0, dhn1


def bigru_scan_bwd_cuda(p0, p1, wh, bh, tmask, out, dout):
    """Launch K2-bwd on CUDA tensors (the coefficient kernel, then the
    reverse chain); same contract as the plain version."""
    T, B, H3 = p0.shape
    H = H3 // 3
    dt = p0.dtype
    _check_bigru("bigru backward kernel", H,
                 [(p0, (T, B, H3), dt), (p1, (T, B, H3), dt), (wh, (2, H, H3), dt),
                  (bh, (2, H3), dt), (out, (T, B, 2 * H), dt), (dout, (T, B, 2 * H), dt)])
    c4, ch = bigru_bwd_coeffs_cuda(p0, p1, wh, bh, tmask, out)
    return bigru_bwd_chain_cuda(c4, ch, wh, dout)


def _weight_grads(out, dxp0, dxp1, dhn0, dhn1, wh_dtype, bh_dtype):
    """dwh [2, H, 3H] and dbh [2, 3H] as whole-trajectory products of the
    h_prev trajectories with (dxp's r, z blocks, dhn), f32 accumulation,
    returned in wh's and bh's dtypes (``_bwd2_rule``)."""
    H = out.shape[-1] // 2
    f32 = torch.float32
    dwh, dbh = [], []
    for h, dxp, dhn in zip(_prev_states(out), (dxp0, dxp1), (dhn0, dhn1)):
        hf = h.to(f32).reshape(-1, H)
        drz = dxp[..., :2 * H].to(f32).reshape(-1, 2 * H)
        dn = dhn.to(f32).reshape(-1, H)
        dwh.append(torch.cat([hf.T @ drz, hf.T @ dn], -1))
        dbh.append(torch.cat([drz.sum(0), dn.sum(0)]))
    return torch.stack(dwh).to(wh_dtype), torch.stack(dbh).to(bh_dtype)


class BiGRUScan(torch.autograd.Function):
    """K2 forward, K2-bwd backward (``pallas_bigru_scan``'s custom VJP):
    the forward saves (p0, p1, wh, bh, tmask, out), as ``_fwd2_rule``
    does."""

    @staticmethod
    def forward(ctx, p0, p1, wh, bh, tmask):
        from uasr_torch.ops import library

        out = library.bigru_scan(p0, p1, wh, bh, tmask)
        ctx.save_for_backward(p0, p1, wh, bh, tmask, out)
        return out

    @staticmethod
    def backward(ctx, dout):
        p0, p1, wh, bh, tmask, out = ctx.saved_tensors
        fn = bigru_scan_bwd_cuda if dout.is_cuda else bigru_scan_bwd_reference
        dxp0, dxp1, dhn0, dhn1 = fn(p0, p1, wh, bh, tmask, out, dout.contiguous())
        dwh, dbh = _weight_grads(out, dxp0, dxp1, dhn0, dhn1, wh.dtype, bh.dtype)
        return dxp0, dxp1, dwh, dbh, None


def bigru_scan(p0, p1, wh, bh, tmask):
    """Two-stream BiGRU recurrence, differentiable: K2 / K2-bwd for CUDA
    tensors, their plain versions for CPU tensors. Without a gradient to
    take, only the operator ``uasr::bigru_scan`` runs (the route of an
    exported program)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (p0, p1, wh, bh)):
        return BiGRUScan.apply(p0, p1, wh, bh, tmask)
    from uasr_torch.ops import library

    return library.bigru_scan(p0, p1, wh, bh, tmask)


# ------------------------------------------------------- K5, K5-bwd, K8


def _gates(xp, hp, h_prev):
    """Reset-after gates in f32 (``_gates_2d``): r, z, n and hn."""
    H = h_prev.shape[-1]
    xr, xz, xn = xp.split(H, -1)
    hr, hz, hn = hp.split(H, -1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    n = torch.tanh(xn + r * hn)
    return r, z, n, hn


def _coeffs(r, z, n, hn, h_prev, mf):
    """The backward step's linearisation coefficients, f32
    (``_fwd_kernel`` with ``save_coeffs``, K5-bwd's coefficient kernel):
    c4 = (c_r, c_z, c_n2, c_nh) [..., 4H] and ch = (1 - mf) + mf z."""
    c_n2 = mf * ((1.0 - z) * (1.0 - n * n))
    c4 = torch.cat([c_n2 * (hn * (r * (1.0 - r))), mf * ((h_prev - n) * (z * (1.0 - z))),
                    c_n2, c_n2 * r], -1)
    return c4, (1.0 - mf) + mf * z


def gru_scan_reference(xproj, wh, bh, tmask, save_coeffs: bool = False):
    """Plain version of K5, step for step.

    xproj [T, G, B, 3H] input projections (bias added); wh [G, H, 3H];
    bh [G, 3H]; tmask [T, G, B] (1 = step active). Every group scans
    forward in frame order. Returns ys [T, G, B, H] in xproj's dtype. The
    recurrent product takes h in wh's dtype with f32 accumulation, the
    gates run in f32, and the carry is rounded to the output dtype every
    step and reread from that value, as the kernel does. With
    ``save_coeffs`` also returns the backward's coefficients from the same
    gates: c4 [T, G, B, 4H] in xproj's dtype and ch [T, G, B, H] in f32.
    """
    T, G, B, H3 = xproj.shape
    H = H3 // 3
    mask = tmask.to(torch.float32)[..., None]  # [T, G, B, 1]
    w = wh.to(torch.float32)
    bias = bh.to(torch.float32)[:, None, :]
    h = torch.zeros(G, B, H, dtype=torch.float32, device=xproj.device)
    ys, c4s, chs = [], [], []
    for t in range(T):
        hp = torch.bmm(h.to(wh.dtype).to(torch.float32), w) + bias
        r, z, n, hn = _gates(xproj[t].to(torch.float32), hp, h)
        h_cand = (1.0 - z) * n + z * h
        mf = mask[t]
        h_store = (mf * h_cand + (1.0 - mf) * h).to(xproj.dtype)
        ys.append(h_store)
        if save_coeffs:
            c4, ch = _coeffs(r, z, n, hn, h, mf)
            c4s.append(c4.to(xproj.dtype))
            chs.append(ch)
        h = h_store.to(torch.float32)
    if save_coeffs:
        return torch.stack(ys), torch.stack(c4s), torch.stack(chs)
    return torch.stack(ys)


def _reverse_chain(c4, ch, dy, wh, out_dtype):
    """The reverse chain of K5-bwd and of K8, step for step:
    d = dh + dy[t] (f32); e = c4[t] * d per gate block, stored in
    ``out_dtype``; dh = ch[t] d + (e_r, e_z, e_nh)->wh.dtype @ wh^T (f32
    accumulation). Returns e [T, G, B, 4H] = (dr_pre, dz_pre, dn_pre, dhn)."""
    T, G, B, H = dy.shape
    f32 = torch.float32
    w_t = wh.to(f32).transpose(1, 2)  # [G, 3H, H]
    dh = torch.zeros(G, B, H, dtype=f32, device=dy.device)
    out = torch.empty(T, G, B, 4 * H, dtype=out_dtype, device=dy.device)
    for t in reversed(range(T)):
        d = dh + dy[t].to(f32)
        e = c4[t].to(f32) * d.repeat(1, 1, 4)
        out[t] = e.to(out_dtype)
        dhproj = torch.cat([e[..., :2 * H], e[..., 3 * H:]], -1).to(wh.dtype).to(f32)
        dh = ch[t] * d + torch.bmm(dhproj, w_t)
    return out


def _prev_trajectory(ys):
    """h_prev at every step: ys shifted one step, zeros at t = 0."""
    return torch.cat([torch.zeros_like(ys[:1]), ys[:-1]])


def gru_bwd_coeffs_reference(xproj, wh, bh, tmask, ys):
    """Plain version of K5-bwd's coefficient kernel (``_bwd_kernel``'s
    first phase, all steps at once): hp = h_prev @ wh + bh (h_prev read in
    the stored dtype, f32 accumulation) and the gates in f32 into the
    coefficients c4 [T, G, B, 4H] and ch [T, G, B, H], both f32."""
    f32 = torch.float32
    h_prev = _prev_trajectory(ys).to(f32)
    hp = torch.matmul(h_prev, wh.to(f32)) + bh.to(f32)[:, None, :]
    r, z, n, hn = _gates(xproj.to(f32), hp, h_prev)
    return _coeffs(r, z, n, hn, h_prev, tmask.to(f32)[..., None])


def gru_scan_bwd_reference(xproj, wh, bh, tmask, ys, dy):
    """Plain version of K5-bwd (``_bwd_fused``), step for step.

    K5's inputs, its output ys and the cotangent dy [T, G, B, H]. The
    coefficients of ``gru_bwd_coeffs_reference``, then the reverse chain.
    Returns (dxp [T, G, B, 3H], dhn [T, G, B, H]) in xproj's dtype: d of
    the input projections and of the n block of h_prev @ wh."""
    H = ys.shape[-1]
    c4, ch = gru_bwd_coeffs_reference(xproj, wh, bh, tmask, ys)
    out = _reverse_chain(c4, ch, dy, wh, xproj.dtype)
    return out[..., :3 * H], out[..., 3 * H:]


def gru_scan_bwd_lin_reference(c4, ch, dy, wh):
    """Plain version of K8 (``_bwd_linear``): the reverse chain from the
    forward's coefficients c4 [T, G, B, 4H] and ch [T, G, B, H] (f32).
    Returns [T, G, B, 4H] = (dr_pre, dz_pre, dn_pre, dhn) in dy's dtype."""
    return _reverse_chain(c4, ch, dy, wh, dy.dtype)


def _launch_args(dev):
    return (torch.cuda.current_stream(dev).cuda_stream,
            dev.index if dev.index is not None else torch.cuda.current_device())


def _check_gru(what, dt, H, G, tensors):
    if dt not in _DTYPES:
        raise ValueError(f"{what} takes float32 or bfloat16, got {dt}")
    dev = tensors[0][0].device
    for t, shape, tdt in tensors:
        if t.shape != shape or t.dtype != tdt or t.device != dev or not t.is_contiguous():
            raise ValueError(f"{what}: expected contiguous {tdt} {shape} on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if H % 8:
        raise ValueError(f"{what} takes a hidden size that is a multiple of 8, got {H}")
    if G > _GRU_BAR_GROUPS:
        raise ValueError(f"{what} takes at most {_GRU_BAR_GROUPS} groups, got {G}")


def _check_grid(what, G, H, dev):
    """The persistent grids of K2, K2-bwd, K5, K5-bwd and K8 hold one CTA
    of at most 64 hidden units per SM: G ceil(H / 64) CTAs must fit the
    card's SMs (wh streams through shared memory where it does not stay
    there)."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    if G * -(-H // _GRU_MAX_UNITS) > sms:
        raise ValueError(f"{what} takes G * ceil(H / {_GRU_MAX_UNITS}) <= {sms} (one CTA per "
                         f"SM), got G = {G}, H = {H}")


def _lib_gru() -> ctypes.CDLL:
    lib = _build.load("gru_fwd")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.uasr_gru_fwd.argtypes = [P] * 8 + [I] * 6 + [P, I, P, P, P]
    lib.uasr_gru_fwd.restype = I
    return lib


def gru_scan_cuda(xproj, wh, bh, tmask, save_coeffs: bool = False):
    """Launch K5 on CUDA tensors; same contract as the plain version."""
    global LAUNCHES_GRU, LAST_GRU_PLAN, LAST_GRU_WH
    T, G, B, H3 = xproj.shape
    H = H3 // 3
    dt = xproj.dtype
    if not xproj.is_cuda:
        raise ValueError("gru kernel takes CUDA tensors; gru_scan runs the plain version on "
                         "the CPU")
    _check_gru("gru kernel", dt, H, G,
               [(xproj, (T, G, B, H3), dt), (wh, (G, H, H3), dt), (bh, (G, H3), dt)])
    if tmask.shape != (T, G, B):
        raise ValueError(f"gru kernel: tmask must be [T, G, B], got {tuple(tmask.shape)}")
    dev = xproj.device
    _check_grid("gru kernel", G, H, dev)
    mask = tmask.to(device=dev, dtype=torch.float32).contiguous()
    ys = torch.empty(T, G, B, H, dtype=dt, device=dev)
    c4 = torch.empty(T, G, B, 4 * H, dtype=dt, device=dev) if save_coeffs else None
    ch = torch.empty(T, G, B, H, dtype=torch.float32, device=dev) if save_coeffs else None
    bar = torch.zeros(2 * 32 * _GRU_BAR_GROUPS, dtype=torch.int32, device=dev)
    units, splits, streamed = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    lib = _lib_gru()
    code = lib.uasr_gru_fwd(
        xproj.data_ptr(), wh.data_ptr(), bh.data_ptr(), mask.data_ptr(), ys.data_ptr(),
        None if c4 is None else c4.data_ptr(), None if ch is None else ch.data_ptr(),
        bar.data_ptr(), _GRU_BAR_GROUPS, T, G, B, H, _DTYPES[dt], *_launch_args(dev),
        ctypes.byref(units), ctypes.byref(splits), ctypes.byref(streamed),
    )
    _build.check(lib, code, "gru_fwd kernel")
    LAUNCHES_GRU += 1
    LAST_GRU_PLAN = (units.value, splits.value)
    LAST_GRU_WH = _WH[streamed.value]
    return (ys, c4, ch) if save_coeffs else ys


def _lib_gru_bwd() -> ctypes.CDLL:
    lib = _build.load("gru_bwd")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.uasr_gru_bwd_coeffs.argtypes = [P] * 7 + [I] * 5 + [P, I]
    lib.uasr_gru_bwd_coeffs.restype = I
    lib.uasr_gru_bwd.argtypes = [P] * 9 + [I] * 6 + [P, I, P, P, P]
    lib.uasr_gru_bwd.restype = I
    return lib


def _check_gru_bwd(what, xproj, wh, bh, tmask, ys, dy=None):
    T, G, B, H3 = xproj.shape
    H = H3 // 3
    dt = xproj.dtype
    if not xproj.is_cuda:
        raise ValueError(f"{what} takes CUDA tensors; GRUScan runs the plain version on the CPU")
    _check_gru(what, dt, H, G,
               [(xproj, (T, G, B, H3), dt), (wh, (G, H, H3), dt), (bh, (G, H3), dt),
                (ys, (T, G, B, H), dt)] + ([] if dy is None else [(dy, (T, G, B, H), dt)]))
    if tmask.shape != (T, G, B):
        raise ValueError(f"{what}: tmask must be [T, G, B], got {tuple(tmask.shape)}")


def gru_bwd_coeffs_cuda(xproj, wh, bh, tmask, ys):
    """Launch K5-bwd's coefficient kernel on CUDA tensors; same contract as
    ``gru_bwd_coeffs_reference``."""
    global LAUNCHES_GRU_COEFFS
    _check_gru_bwd("gru backward coefficient kernel", xproj, wh, bh, tmask, ys)
    T, G, B, H3 = xproj.shape
    H = H3 // 3
    dev = xproj.device
    f32 = torch.float32
    mask = tmask.to(device=dev, dtype=f32).contiguous()
    c4 = torch.empty(T, G, B, 4 * H, dtype=f32, device=dev)
    ch = torch.empty(T, G, B, H, dtype=f32, device=dev)
    lib = _lib_gru_bwd()
    code = lib.uasr_gru_bwd_coeffs(
        xproj.data_ptr(), wh.data_ptr(), bh.data_ptr(), mask.data_ptr(), ys.data_ptr(),
        c4.data_ptr(), ch.data_ptr(), T, G, B, H, _DTYPES[xproj.dtype], *_launch_args(dev),
    )
    _build.check(lib, code, "gru_bwd coefficient kernel")
    LAUNCHES_GRU_COEFFS += 1
    return c4, ch


def gru_scan_bwd_cuda(xproj, wh, bh, tmask, ys, dy):
    """Launch K5-bwd on CUDA tensors (the coefficient kernel, then the
    reverse chain); same contract as the plain version."""
    global LAUNCHES_GRU_BWD, LAST_GRU_BWD_PLAN, LAST_GRU_BWD_WH
    _check_gru_bwd("gru backward kernel", xproj, wh, bh, tmask, ys, dy)
    T, G, B, H3 = xproj.shape
    H = H3 // 3
    dt = xproj.dtype
    dev = xproj.device
    _check_grid("gru backward kernel", G, H, dev)
    f32 = torch.float32
    c4, ch = gru_bwd_coeffs_cuda(xproj, wh, bh, tmask, ys)
    dxp = torch.empty(T, G, B, H3, dtype=dt, device=dev)
    dhn = torch.empty(T, G, B, H, dtype=dt, device=dev)
    chd = torch.empty(G, B, H, dtype=f32, device=dev)  # ch * d carried to the next step
    xch = torch.empty(2, G, B, H3, dtype=dt, device=dev)  # per-step exchange rows
    bar = torch.zeros(2 * 32 * _GRU_BAR_GROUPS, dtype=torch.int32, device=dev)
    units, splits, streamed = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    lib = _lib_gru_bwd()
    code = lib.uasr_gru_bwd(
        c4.data_ptr(), ch.data_ptr(), dy.data_ptr(), wh.data_ptr(), dxp.data_ptr(),
        dhn.data_ptr(), chd.data_ptr(), xch.data_ptr(), bar.data_ptr(), _GRU_BAR_GROUPS, T, G,
        B, H, _DTYPES[dt], *_launch_args(dev), ctypes.byref(units), ctypes.byref(splits),
        ctypes.byref(streamed),
    )
    _build.check(lib, code, "gru_bwd kernel")
    LAUNCHES_GRU_BWD += 1
    LAST_GRU_BWD_PLAN = (units.value, splits.value)
    LAST_GRU_BWD_WH = _WH[streamed.value]
    return dxp, dhn


def _lib_gru_lin() -> ctypes.CDLL:
    lib = _build.load("gru_bwd_lin")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.uasr_gru_bwd_lin.argtypes = [P] * 8 + [I] * 6 + [P, I, P, P, P]
    lib.uasr_gru_bwd_lin.restype = I
    return lib


def gru_scan_bwd_lin_cuda(c4, ch, dy, wh):
    """Launch K8 on CUDA tensors; same contract as the plain version."""
    global LAUNCHES_GRU_LIN, LAST_GRU_BWD_PLAN, LAST_GRU_BWD_WH
    T, G, B, H = dy.shape
    dt = dy.dtype
    if not dy.is_cuda:
        raise ValueError("gru linear backward kernel takes CUDA tensors; GRUScan runs the "
                         "plain version on the CPU")
    _check_gru("gru linear backward kernel", dt, H, G,
               [(dy, (T, G, B, H), dt), (c4, (T, G, B, 4 * H), dt),
                (ch, (T, G, B, H), torch.float32), (wh, (G, H, 3 * H), dt)])
    dev = dy.device
    _check_grid("gru linear backward kernel", G, H, dev)
    out = torch.empty(T, G, B, 4 * H, dtype=dt, device=dev)
    chd = torch.empty(G, B, H, dtype=torch.float32, device=dev)
    xch = torch.empty(2, G, B, 3 * H, dtype=dt, device=dev)
    bar = torch.zeros(2 * 32 * _GRU_BAR_GROUPS, dtype=torch.int32, device=dev)
    units, splits, streamed = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    lib = _lib_gru_lin()
    code = lib.uasr_gru_bwd_lin(
        c4.data_ptr(), ch.data_ptr(), dy.data_ptr(), wh.data_ptr(), out.data_ptr(),
        chd.data_ptr(), xch.data_ptr(), bar.data_ptr(), _GRU_BAR_GROUPS, T, G, B, H,
        _DTYPES[dt], *_launch_args(dev), ctypes.byref(units), ctypes.byref(splits),
        ctypes.byref(streamed),
    )
    _build.check(lib, code, "gru_bwd_lin kernel")
    LAUNCHES_GRU_LIN += 1
    LAST_GRU_BWD_PLAN = (units.value, splits.value)
    LAST_GRU_BWD_WH = _WH[streamed.value]
    return out


def _gru_weight_grads(ys, drz, dn, wh_dtype, bh_dtype):
    """dwh [G, H, 3H] and dbh [G, 3H] as whole-trajectory products of the
    h_prev trajectory with the rounded (dr_pre, dz_pre) and dhn, f32
    accumulation, returned in wh's and bh's dtypes (``_bwd_fused``,
    ``_bwd_linear``)."""
    f32 = torch.float32
    h = _prev_trajectory(ys).to(f32)
    drz, dn = drz.to(f32), dn.to(f32)
    dwh = torch.cat([torch.einsum("tgbh,tgbo->gho", h, drz),
                     torch.einsum("tgbh,tgbo->gho", h, dn)], -1)
    dbh = torch.cat([drz.sum((0, 2)), dn.sum((0, 2))], -1)
    return dwh.to(wh_dtype), dbh.to(bh_dtype)


class GRUScan(torch.autograd.Function):
    """K5 forward, K5-bwd or K8 backward (``pallas_gru_scan``'s custom
    VJP). The forward saves what ``_fwd_rule`` saves: (xproj, wh, bh,
    tmask, ys) for ``fused``, (wh, bh, ys, c4, ch) for ``linear``, the
    implementation being read when the forward runs."""

    @staticmethod
    def forward(ctx, xproj, wh, bh, tmask):
        from uasr_torch.ops import library

        ctx.linear = BWD_IMPL == "linear"
        ys, c4, ch = library.gru_scan(xproj, wh, bh, tmask, ctx.linear)
        if ctx.linear:
            ctx.save_for_backward(wh, bh, ys, c4, ch)
        else:
            ctx.save_for_backward(xproj, wh, bh, tmask, ys)
        return ys

    @staticmethod
    def backward(ctx, dy):
        dy = dy.contiguous()
        H = dy.shape[-1]
        if ctx.linear:
            wh, bh, ys, c4, ch = ctx.saved_tensors
            fn = gru_scan_bwd_lin_cuda if dy.is_cuda else gru_scan_bwd_lin_reference
            out = fn(c4, ch, dy, wh)
            dxp, drz, dn = out[..., :3 * H], out[..., :2 * H], out[..., 3 * H:]
        else:
            xproj, wh, bh, tmask, ys = ctx.saved_tensors
            fn = gru_scan_bwd_cuda if dy.is_cuda else gru_scan_bwd_reference
            dxp, dn = fn(xproj, wh, bh, tmask, ys, dy)
            drz = dxp[..., :2 * H]
        dwh, dbh = _gru_weight_grads(ys, drz, dn, wh.dtype, bh.dtype)
        return dxp, dwh, dbh, None


def gru_scan(xproj, wh, bh, tmask):
    """Grouped GRU recurrence (``pallas_gru_scan``): K5 for CUDA tensors,
    its plain version for CPU tensors; differentiable through ``GRUScan``
    (K5-bwd or K8, or their plain versions). Without a gradient to take,
    only the forward runs (the operator ``uasr::gru_scan``), as under JAX's
    custom VJP."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (xproj, wh, bh)):
        return GRUScan.apply(xproj, wh, bh, tmask)
    from uasr_torch.ops import library

    return library.gru_scan(xproj, wh, bh, tmask, False)[0]
