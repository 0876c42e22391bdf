"""The collectives the port uses, as autograd-aware functions, and the
helpers that make a loss a global-batch quantity (the counterpart of what
GSPMD inserts around the JAX package's jitted steps).

Each function is a ``torch.autograd.Function`` whose backward is another
of them, so a gradient of a gradient (the critic's gradient penalty)
differentiates through the collectives too. The pairs, each the other's
transpose:

- ``reduce_fwd`` / ``reduce_bwd``: all-reduce (sum) forward and identity
  backward, and identity forward and all-reduce backward (Megatron's "g"
  and "f"). A row-parallel product's partial sums go through
  ``reduce_fwd``; the replicated input of a column-parallel product goes
  through ``reduce_bwd``, which sums the ranks' partial input gradients;
- ``gather`` / ``split``: all-gather of the ranks' slices along ``dim``
  into a tensor every rank then uses whole, and the rank's own slice of a
  replicated tensor (its backward gathers the slices' gradients);
- ``gather_partial`` / ``reduce_scatter``: all-gather along ``dim`` into a
  tensor whose consumers make partial sums (the sequence-parallel gather
  before a column-parallel product; its backward reduce-scatters), and
  reduce-scatter of partial sums into the rank's slice (after a
  row-parallel product; its backward all-gathers).

Reduce-scatter is built from ``all_reduce`` plus a slice, on every
backend: gloo has no reduce-scatter for CUDA tensors, and the same code
path runs in the one-card gloo rehearsal and under NCCL. All-gather is
``dist.all_gather`` into a list, which gloo takes for CPU and CUDA
tensors. A refused collective raises; nothing falls back.

With ``active(mesh)`` (``uasr_torch.parallel.mesh``) set around a step,
``batch_sum`` makes a sum over the batch global over the data group
(through ``reduce_fwd``: each rank's backward is then its own rows' share
of the gradient, and the trainer's gradient all-reduce sums the shares),
and ``global_rows`` / ``local_rows`` let a random draw be made for the
global batch and cut to the rank's rows, so a rank's step is the
one-process step on the global batch. Without an active mesh they are
identities.
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

_ACTIVE = None  # the Mesh of the step being run, set by ``active``


@contextlib.contextmanager
def active(mesh):
    """Run the enclosed step under ``mesh`` (None: one process)."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, mesh
    try:
        yield mesh
    finally:
        _ACTIVE = prev


def current():
    """The mesh of the running step, or None."""
    return _ACTIVE


def _size(group) -> int:
    return dist.get_world_size(group)


def _rank(group) -> int:
    return dist.get_rank(group)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    y = x.contiguous().clone()
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
    return y


def _all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim)


def _own(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = _size(group)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of size {x.shape[dim]} does not split over {n} ranks")
    return x.chunk(n, dim)[_rank(group)].contiguous()


class _ReduceFwd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _ReduceBwd.apply(g, ctx.group), None


class _ReduceBwd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _ReduceFwd.apply(g, ctx.group), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _Split.apply(g, ctx.dim, ctx.group), None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _own(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _Gather.apply(g, ctx.dim, ctx.group), None, None


class _GatherPartial(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _ReduceScatter.apply(g, ctx.dim, ctx.group), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _own(_all_reduce(x, group), dim, group)

    @staticmethod
    def backward(ctx, g):
        return _GatherPartial.apply(g, ctx.dim, ctx.group), None, None


def reduce_fwd(x: torch.Tensor, group) -> torch.Tensor:
    """All-reduce (sum) forward, identity backward."""
    return _ReduceFwd.apply(x, group)


def reduce_bwd(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward, all-reduce (sum) backward."""
    return _ReduceBwd.apply(x, group)


def gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """All-gather along ``dim`` into a tensor every rank uses whole;
    backward keeps the rank's own slice."""
    return _Gather.apply(x, dim, group)


def split(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The rank's own slice of a replicated tensor along ``dim``;
    backward all-gathers the slices' gradients."""
    return _Split.apply(x, dim, group)


def gather_partial(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """All-gather along ``dim`` into a tensor that feeds partial sums;
    backward reduce-scatters."""
    return _GatherPartial.apply(x, dim, group)


def reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Sum of the ranks' partial ``x``, cut to the rank's slice along
    ``dim`` (all-reduce plus a slice on every backend); backward
    all-gathers."""
    return _ReduceScatter.apply(x, dim, group)


# ------------------------------------------------ global-batch helpers


def _data():
    m = _ACTIVE
    return None if m is None or m.data_size == 1 else m


def batch_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` (a sum over this rank's rows) summed over the data group."""
    m = _data()
    return x if m is None else reduce_fwd(x, m.data_group)


def batch_mean(per_row: torch.Tensor) -> torch.Tensor:
    """The mean of ``per_row`` [B] over the global batch (equal shards)."""
    m = _data()
    if m is None:
        return per_row.mean()
    return batch_sum(per_row.sum()) / (per_row.shape[0] * m.data_size)


def global_rows(b_local: int) -> int:
    """Rows of the global batch a draw for ``b_local`` rows must cover."""
    m = _data()
    return b_local if m is None else b_local * m.data_size


def local_rows(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """This rank's rows of ``x``, a draw made for the global batch along
    ``dim``."""
    m = _data()
    if m is None:
        return x
    n = x.shape[dim] // m.data_size
    return x.narrow(dim, m.data_rank * n, n)


def all_reduce_grads(grads: dict, group) -> dict:
    """Sum a dict of gradients over ``group`` in one flat all-reduce per
    dtype (the gradient bucket)."""
    out = dict(grads)
    by_dtype: dict = {}
    for k, g in grads.items():
        by_dtype.setdefault(g.dtype, []).append(k)
    for keys in by_dtype.values():
        flat = torch.cat([grads[k].reshape(-1) for k in keys])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        off = 0
        for k in keys:
            n = grads[k].numel()
            out[k] = flat[off: off + n].view_as(grads[k])
            off += n
    return out
