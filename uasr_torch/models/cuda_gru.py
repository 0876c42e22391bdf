"""K2, the two-stream BiGRU forward recurrence: wrapper of
``csrc/bigru_fwd.cu`` and its plain PyTorch version.

Counterpart of ``uasr/models/pallas_gru.py::pallas_bigru_scan`` (TPU
kernel ``_fwd2_kernel``), forward only; the backward kernel comes with
the training slice. ``bigru_scan`` launches the kernel for CUDA tensors
and runs ``bigru_scan_reference`` for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from uasr_torch import _build

LAUNCHES = 0  # kernel launches by bigru_scan (read by chip_smoke.py)
LAST_UNITS = None  # hidden units per CTA of the last launch

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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
    lib.uasr_bigru_fwd.argtypes = [P, P, P, P, P, P, P, I, I, I, I, P, I, P]
    lib.uasr_bigru_fwd.restype = I
    return lib


def bigru_scan_cuda(p0, p1, wh, bh, tmask):
    """Launch K2 on CUDA tensors; same contract as the plain version."""
    global LAUNCHES, LAST_UNITS
    T, B, H3 = p0.shape
    H = H3 // 3
    dt = p0.dtype
    if dt not in _DTYPES:
        raise ValueError(f"bigru kernel takes float32 or bfloat16, got {dt}")
    for t, shape in ((p0, (T, B, H3)), (p1, (T, B, H3)), (wh, (2, H, H3)), (bh, (2, H3))):
        if t.shape != shape or t.dtype != dt or t.device != p0.device or not t.is_contiguous():
            raise ValueError(f"bigru kernel: expected contiguous {dt} {shape} on {p0.device}")
    if H % 8:
        raise ValueError(f"bigru kernel takes a hidden size that is a multiple of 8, got {H}")
    if tmask.shape != (T, 2, B):
        raise ValueError(f"bigru kernel: tmask must be [T, 2, B], got {tuple(tmask.shape)}")
    mask = tmask.to(device=p0.device, dtype=torch.float32).contiguous()
    out = torch.empty(T, B, 2 * H, dtype=dt, device=p0.device)
    bar = torch.zeros(4 * 32, dtype=torch.int32, device=p0.device)  # barrier words
    units = ctypes.c_int(0)
    lib = _lib()
    code = lib.uasr_bigru_fwd(
        p0.data_ptr(), p1.data_ptr(), wh.data_ptr(), bh.data_ptr(), mask.data_ptr(),
        out.data_ptr(), bar.data_ptr(), T, B, H, _DTYPES[dt],
        torch.cuda.current_stream(p0.device).cuda_stream,
        p0.device.index if p0.device.index is not None else torch.cuda.current_device(),
        ctypes.byref(units),
    )
    _build.check(lib, code, "bigru_fwd kernel")
    LAUNCHES += 1
    LAST_UNITS = units.value
    return out


def bigru_scan(p0, p1, wh, bh, tmask):
    """Two-stream BiGRU recurrence: K2 for CUDA tensors, the plain
    version for CPU tensors."""
    fn = bigru_scan_cuda if p0.is_cuda else bigru_scan_reference
    return fn(p0, p1, wh, bh, tmask)
