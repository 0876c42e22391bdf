"""K-norm and K-adam, ``ClipAdam``'s global-norm clip and Adam over every
leaf in two launches: wrappers of ``csrc/clip_adam.cu``, their plain
PyTorch versions (the per-leaf code, which the CPU runs and the tests hold
against optax), and the host side of the launches.

No TPU kernel is replaced: the JAX package leaves optax's update to XLA,
which fuses it. Per leaf the plain version makes some 19 elementwise
launches, so the host paced the card through the update; the kernels make
two for up to ``TABLE_LEAVES`` leaves, take the leaves' pointers by value
in their parameters (nothing is copied to the card, nothing waits), and
read the norm from the device, so the update neither synchronises nor
copies. Leaves are cut into chunks of ``CHUNK`` elements; ``plan_tables``
splits a list of leaves into tables, and a CTA finds a chunk's leaf by a
binary search over the table's prefix of chunk counts.

``sq_norms`` returns the sums of squares of the sharded and the replicated
gradients and the norm of all of them; ``clip_adam`` clips by that norm
and applies Adam to the parameters and both moments in place. Each
launches its kernel for CUDA tensors (and raises on input the kernel does
not take) and runs the plain version for CPU tensors. Below the clip an
f32 leaf comes out of K-adam bit for bit as the plain version's; above it
the norm, summed in another order, may differ in its last bits.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from uasr_torch import _build, profiling

TABLE_LEAVES = 64  # leaves a launch takes (the kernels' parameter space)
CHUNK = 4096  # elements of a chunk
LAUNCHES = 0  # K-norm and K-adam launches

_P_BF16, _G_BF16, _SHARDED, _VEC4 = 1, 2, 4, 8


class _Table(ctypes.Structure):
    """``LeafTable`` of ``csrc/clip_adam.cu``, passed by value to the
    kernels."""

    _fields_ = [("p", ctypes.c_void_p * TABLE_LEAVES), ("g", ctypes.c_void_p * TABLE_LEAVES),
                ("m", ctypes.c_void_p * TABLE_LEAVES), ("v", ctypes.c_void_p * TABLE_LEAVES),
                ("n", ctypes.c_longlong * TABLE_LEAVES),
                ("chunk_start", ctypes.c_int * (TABLE_LEAVES + 1)),
                ("flags", ctypes.c_ubyte * TABLE_LEAVES), ("n_leaves", ctypes.c_int)]


def host_scalars(count: int, b1: float, b2: float, lr: float) -> tuple[float, float, float]:
    """(bc1, bc2, step_size) of the ``count``-th update at learning rate
    ``lr``: Adam's bias corrections 1 - b^count in f32 on the CPU and the
    negated f32 rate, as Python floats (every one an f32 value)."""
    f32 = torch.float32
    bc1 = float(1.0 - torch.tensor(b1, dtype=f32) ** count)
    bc2 = float(1.0 - torch.tensor(b2, dtype=f32) ** count)
    return bc1, bc2, -float(np.float32(lr))


def plan_tables(sizes, table_leaves: int = TABLE_LEAVES) -> list[tuple[range, list[int]]]:
    """The launches' tables for leaves of ``sizes`` elements: per table,
    the leaves it holds (up to ``table_leaves``, in order) and the prefix
    of their chunk counts (``chunk_start``, one entry more than leaves).
    No leaves still make one empty table."""
    sizes = list(sizes)
    out = []
    for lo in range(0, max(len(sizes), 1), table_leaves):
        leaves = range(lo, min(lo + table_leaves, len(sizes)))
        start = [0]
        for i in leaves:
            start.append(start[-1] + -(-sizes[i] // CHUNK))
        out.append((leaves, start))
    return out


def grid(chunk_start, max_ctas: int) -> int:
    """CTAs of a launch over a table: one a chunk up to ``max_ctas``, at
    least one."""
    return max(1, min(chunk_start[-1], max_ctas))


# ---------------------------------------------------------- plain versions


def sq_norms_reference(grads, sharded=None):
    """Plain version of K-norm: (sum of squares of the ``sharded``
    gradients, of the others, sqrt of their sum), 0-d f32 tensors, the
    leaves summed one by one in order. Without ``sharded``, no gradient is
    sharded and the third is the global norm."""
    grads = list(grads)
    if sharded is None:
        sharded = [False] * len(grads)
    sq = [torch.sum(torch.square(g.float())) for g, s in zip(grads, sharded) if s]
    rep = [torch.sum(torch.square(g.float())) for g, s in zip(grads, sharded) if not s]
    zero = lambda: torch.zeros((), device=grads[0].device)  # noqa: E731
    shard = sum(sq) if sq else zero()
    rest = sum(rep) if rep else zero()
    return shard, rest, torch.sqrt(rest + shard)


def clip_adam_reference(params, grads, mu, nu, g_norm, max_norm: float, b1: float, b2: float,
                        eps: float, bc1: float, bc2: float, step_size: float) -> None:
    """Plain version of K-adam, leaf by leaf in PyTorch's elementwise ops:
    each gradient scaled by max_norm / g_norm unless g_norm < max_norm
    (``optax.clip_by_global_norm``), then ``optax.adam``'s update of mu
    and nu and the parameters, in place."""
    keep = g_norm < max_norm
    bc1 = torch.full((), bc1, device=g_norm.device)
    bc2 = torch.full((), bc2, device=g_norm.device)
    for p, g, m, v in zip(params, grads, mu, nu):
        g = torch.where(keep, g, (g / g_norm) * max_norm)
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * torch.square(g))
        p.add_(((m / bc1) / (torch.sqrt(v / bc2) + eps)) * step_size)


# ------------------------------------------------------------ the kernels


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("clip_adam")
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    T, IP = ctypes.POINTER(_Table), ctypes.POINTER(ctypes.c_int)
    lib.uasr_clip_adam_layout.argtypes = [IP, IP, IP]
    lib.uasr_clip_adam_plan.argtypes = [I, IP, IP]
    lib.uasr_clip_adam_norm.argtypes = [T, P, I, I, I, P, P, P, I]
    lib.uasr_clip_adam_update.argtypes = [T, P] + [F] * 9 + [I, P, I]
    for fn in ("layout", "plan", "norm", "update"):
        getattr(lib, f"uasr_clip_adam_{fn}").restype = I
    nbytes, leaves, chunk = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    lib.uasr_clip_adam_layout(ctypes.byref(nbytes), ctypes.byref(leaves), ctypes.byref(chunk))
    if (nbytes.value, leaves.value, chunk.value) != (ctypes.sizeof(_Table), TABLE_LEAVES, CHUNK):
        raise RuntimeError(f"clip_adam.cu's LeafTable ({nbytes.value} bytes, {leaves.value} "
                           f"leaves, chunk {chunk.value}) differs from the wrapper's "
                           f"({ctypes.sizeof(_Table)}, {TABLE_LEAVES}, {CHUNK})")
    return lib


@functools.lru_cache(maxsize=None)
def _max_ctas(device: int) -> tuple[int, int]:
    """The most resident CTAs of K-norm and of K-adam on ``device``."""
    lib = _lib()
    norm, adam = ctypes.c_int(), ctypes.c_int()
    _build.check(lib, lib.uasr_clip_adam_plan(device, ctypes.byref(norm), ctypes.byref(adam)),
                 "clip_adam plan")
    return norm.value, adam.value


def _device(tensors, what: str) -> torch.device:
    dev = tensors[0].device
    for t in tensors:
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{what}: every tensor must be on one CUDA device, got {t.device} "
                             f"beside {dev}")
    return dev


def _check_grads(grads, what: str) -> list[torch.Tensor]:
    """The gradients as the kernels take them: f32 or bf16, contiguous (a
    gradient that autograd left strided is copied)."""
    for g in grads:
        if g.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"{what} takes float32 or bfloat16 gradients, got {g.dtype}")
    return [g if g.is_contiguous() else g.contiguous() for g in grads]


def _tables(grads, sharded=None, params=None, mu=None, nu=None):
    """The ctypes tables of the leaves, with their launches' grid sizes
    still to be chosen: [(table, chunk_start)]."""
    out = []
    for leaves, start in plan_tables([g.numel() for g in grads]):
        t = _Table()
        t.n_leaves = len(leaves)
        t.chunk_start[: len(start)] = start
        for j, i in enumerate(leaves):
            g = grads[i]
            # the pointers as ints: ctypes reads a null c_void_p back as None
            ptrs = [g.data_ptr()]
            t.g[j], t.n[j] = ptrs[0], g.numel()
            flags = _G_BF16 if g.dtype == torch.bfloat16 else 0
            if sharded is not None and sharded[i]:
                flags |= _SHARDED
            if params is not None:
                p = params[i]
                ptrs += [p.data_ptr(), mu[i].data_ptr(), nu[i].data_ptr()]
                t.p[j], t.m[j], t.v[j] = ptrs[1:]
                if p.dtype == torch.bfloat16:
                    flags |= _P_BF16
            if not flags & (_P_BF16 | _G_BF16) and all(x % 16 == 0 for x in ptrs):
                flags |= _VEC4
            t.flags[j] = flags
        out.append((t, start))
    return out


def _launch_args(dev: torch.device) -> tuple[int, int]:
    return (torch.cuda.current_stream(dev).cuda_stream,
            dev.index if dev.index is not None else torch.cuda.current_device())


def sq_norms_cuda(grads, sharded):
    """K-norm on CUDA gradients; same contract as the plain version. The
    three results are views of one fresh device buffer."""
    global LAUNCHES
    dev = _device(grads, "clip_adam norm kernel")
    grads = _check_grads(grads, "clip_adam norm kernel")
    lib = _lib()
    stream, device = _launch_args(dev)
    tables = _tables(grads, sharded)
    grids = [grid(start, _max_ctas(device)[0]) for _, start in tables]
    total = sum(grids)
    # out[0:3], the counter (zero bits), the partials
    scratch = torch.zeros(4 + 2 * total, dtype=torch.float32, device=dev)
    base = scratch.data_ptr()
    part0 = 0
    for (t, _), n in zip(tables, grids):
        code = lib.uasr_clip_adam_norm(ctypes.byref(t), base + 16, part0, n, total, base + 12,
                                       base, stream, device)
        _build.check(lib, code, "clip_adam norm kernel")
        LAUNCHES += 1
        part0 += n
    return scratch[0], scratch[1], scratch[2]


def clip_adam_cuda(params, grads, mu, nu, g_norm, max_norm: float, b1: float, b2: float,
                   eps: float, bc1: float, bc2: float, step_size: float) -> None:
    """K-adam on CUDA tensors; same contract as the plain version.
    Parameters are f32 or bf16, the moments f32, all contiguous and of
    their gradient's shape; ``g_norm`` a 0-d f32 tensor on their device."""
    global LAUNCHES
    what = "clip_adam kernel"
    if not len(params) == len(grads) == len(mu) == len(nu):
        raise ValueError(f"{what}: {len(params)} parameters, {len(grads)} gradients, "
                         f"{len(mu)} and {len(nu)} moments")
    dev = _device([*params, *grads, *mu, *nu, g_norm], what)
    grads = _check_grads(grads, what)
    for p, g, m, v in zip(params, grads, mu, nu):
        if p.dtype not in (torch.float32, torch.bfloat16) or m.dtype != torch.float32 or \
                v.dtype != torch.float32:
            raise ValueError(f"{what} takes float32 or bfloat16 parameters and float32 moments, "
                             f"got {p.dtype}, {m.dtype}, {v.dtype}")
        if not (p.shape == g.shape == m.shape == v.shape):
            raise ValueError(f"{what}: shapes differ: parameter {tuple(p.shape)}, gradient "
                             f"{tuple(g.shape)}, moments {tuple(m.shape)}, {tuple(v.shape)}")
        if not (p.is_contiguous() and m.is_contiguous() and v.is_contiguous()):
            raise ValueError(f"{what} updates contiguous parameters and moments in place")
    if g_norm.dtype != torch.float32 or g_norm.dim() != 0:
        raise ValueError(f"{what}: the norm must be a 0-d float32 tensor, got {g_norm.dtype} "
                         f"{tuple(g_norm.shape)}")
    lib = _lib()
    stream, device = _launch_args(dev)
    scalars = (max_norm, b1, 1 - b1, b2, 1 - b2, eps, bc1, bc2, step_size)
    for t, start in _tables(grads, None, params, mu, nu):
        code = lib.uasr_clip_adam_update(ctypes.byref(t), g_norm.data_ptr(), *scalars,
                                         grid(start, _max_ctas(device)[1]), stream, device)
        _build.check(lib, code, what)
        LAUNCHES += 1
    profiling.count("adam_fused_leaves", len(params))


def sq_norms(grads, sharded):
    """K-norm for CUDA gradients, its plain version for CPU ones."""
    fn = sq_norms_cuda if grads[0].is_cuda else sq_norms_reference
    return fn(grads, sharded)


def clip_adam(params, grads, mu, nu, g_norm, max_norm, b1, b2, eps, bc1, bc2, step_size):
    """K-adam for CUDA tensors, its plain version for CPU ones."""
    fn = clip_adam_cuda if params[0].is_cuda else clip_adam_reference
    fn(params, grads, mu, nu, g_norm, max_norm, b1, b2, eps, bc1, bc2, step_size)
