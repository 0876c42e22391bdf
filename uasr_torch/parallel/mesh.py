"""The (data, model) device mesh (counterpart of ``uasr.parallel.mesh``).

The JAX package runs one process over all local devices and lets GSPMD
place the work from sharding annotations. The port runs one process per
device (``torchrun``) and places the work itself:

- the mesh is a ``torch.distributed.device_mesh.DeviceMesh`` of shape
  ``(world // model_parallel, model_parallel)`` with dims ``("data",
  "model")``; ranks ``d * model_parallel + m`` fill it row by row, so a
  model group is ``model_parallel`` consecutive ranks;
- batches shard their leading axis over ``data`` (``shard_batch``): every
  rank reads the same global batch and keeps its data-group rank's rows,
  and the ranks of one model group see the same rows;
- parameters are replicated unless ``param_shardings`` marks them: the
  leaves JAX's rule shards (flax's last axis divides ``model_parallel``
  and is at least twice it, two or more dims; flax's shapes come from
  ``uasr_torch.convert.flax_shapes``). ``shard_model`` keeps the rank's
  slice of each marked leaf and tells the layers, which then run
  column-parallel with the output gathered over the model group (Dense,
  Conv1d, the 2-D conv blocks), gather the GRU weights a kernel reads
  whole, or, in the attention encoders, split the heads Megatron-style
  (``tp_role``: "col" for query/key/value and the first FFN product,
  "row" for ``out`` and the second), where the shard falls on heads, not
  on flax's ``dh`` axis;
- gradients are summed over ``data`` by the trainers (one flat
  all-reduce), since every loss is the global-batch loss
  (``collectives.batch_sum``).

``replicated`` and ``batch_sharding`` have no counterpart: they are
GSPMD annotations, and here the placement is the code's.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from uasr_torch.parallel import collectives as C


class Mesh:
    """A (data, model) grid over the process group: its groups, sizes and
    this rank's coordinates."""

    def __init__(self, device_mesh):
        self.device_mesh = device_mesh
        self.data_size, self.model_size = (int(s) for s in device_mesh.mesh.shape)
        self.data_group = device_mesh.get_group("data")
        self.model_group = device_mesh.get_group("model")
        self.data_rank = device_mesh.get_local_rank("data")
        self.model_rank = device_mesh.get_local_rank("model")
        self.device_type = device_mesh.device_type

    @property
    def shape(self) -> dict[str, int]:
        return {"data": self.data_size, "model": self.model_size}

    @property
    def rank(self) -> int:
        return dist.get_rank()

    @property
    def is_writer(self) -> bool:
        """Rank 0 writes metrics, hypotheses and checkpoints."""
        return dist.get_rank() == 0

    def barrier(self) -> None:
        dist.barrier()

    def __repr__(self) -> str:
        return f"Mesh(data={self.data_size}, model={self.model_size}, rank={self.rank})"


def make_mesh(model_parallel: int = 1, device_type: str = "cuda") -> Mesh:
    """The (world // model_parallel, model_parallel) mesh over the
    initialised process group (``init_distributed`` first)."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: launch with torchrun and call "
                           "uasr_torch.parallel.init_distributed() first")
    n = dist.get_world_size()
    if n % model_parallel != 0:
        raise ValueError(f"{n} devices not divisible by model={model_parallel}")
    dm = init_device_mesh(device_type, (n // model_parallel, model_parallel),
                          mesh_dim_names=("data", "model"))
    return Mesh(dm)


def _jax_rule_shards(flax_shape: tuple[int, ...], m: int) -> bool:
    """JAX's ``param_shardings`` rule: last-axis sharding for 2-D+ leaves
    whose last dim divides ``m`` and is at least ``2 m``."""
    return m > 1 and len(flax_shape) >= 2 and flax_shape[-1] % m == 0 and flax_shape[-1] >= 2 * m


def param_shardings(model: torch.nn.Module, model_parallel: int) -> dict[str, int | None]:
    """Per parameter name, the axis of the port's tensor its model-group
    shards fall on, or None for a replicated leaf. The leaves marked are
    the ones JAX's rule shards; the axis is the one that maps to flax's
    last axis (output features), except that a row-parallel attention
    product (``tp_role == "row"``: ``out``, the second FFN product) is
    split on its input features, so heads and FFN columns stay whole on a
    rank."""
    from uasr_torch.convert import flax_shapes

    shapes = flax_shapes(model)
    roles = {name: getattr(mod, "tp_role", None) for name, mod in model.named_modules()}
    out: dict[str, int | None] = {}
    for name, p in model.named_parameters():
        if not _jax_rule_shards(shapes[name], model_parallel):
            out[name] = None
            continue
        mname, _, leaf = name.rpartition(".")
        if roles.get(mname) == "row":
            out[name] = 1
        elif leaf in ("wx", "wh", "bx", "bh"):  # the GRUs keep flax's layout
            out[name] = p.ndim - 1
        else:
            out[name] = 0
    return out


class ShardPlan:
    """Which leaves of a model are sharded over the model group, and on
    which axis; moves state between whole tensors (checkpoints) and this
    rank's shards."""

    def __init__(self, mesh: Mesh, dims: dict[str, int]):
        self.mesh, self.dims = mesh, dims

    @torch.no_grad()
    def shard(self, tree: dict) -> dict:
        """This rank's slices of a dict of whole tensors keyed by name."""
        m, r = self.mesh.model_size, self.mesh.model_rank
        return {k: (v.chunk(m, self.dims[k])[r].contiguous() if k in self.dims else v)
                for k, v in tree.items()}

    @torch.no_grad()
    def gather(self, tree: dict) -> dict:
        """Whole tensors of a dict of this rank's shards (a collective over
        the model group)."""
        return {k: (C._all_gather(v.detach(), self.dims[k], self.mesh.model_group)
                    if k in self.dims else v) for k, v in tree.items()}

    def global_sq(self, sharded_sq: torch.Tensor, replicated_sq: torch.Tensor) -> torch.Tensor:
        """Sum of squares of the global gradient from this rank's two sums:
        its sharded leaves' (summed over the model group, so each shard
        counts once) and its replicated leaves' (counted once)."""
        return replicated_sq + C._all_reduce(sharded_sq.reshape(1), self.mesh.model_group)[0]


def shard_model(model: torch.nn.Module, mesh: Mesh) -> ShardPlan:
    """Keep this rank's slice of each leaf ``param_shardings`` marks (the
    module's parameter is replaced by it) and set each module's ``tp``
    (the mesh) and ``tp_sharded`` (the names of its own sharded
    parameters), which the layers read in ``forward``."""
    m, r = mesh.model_size, mesh.model_rank
    dims = {k: d for k, d in param_shardings(model, m).items() if d is not None}
    for mname, mod in model.named_modules():
        own = set()
        for pname, p in list(mod.named_parameters(recurse=False)):
            name = f"{mname}.{pname}" if mname else pname
            if name in dims:
                own.add(pname)
                setattr(mod, pname, torch.nn.Parameter(
                    p.detach().chunk(m, dims[name])[r].contiguous()))
        mod.tp, mod.tp_sharded = mesh, frozenset(own)
    check = getattr(model, "check_tensor_parallel", None)
    if check is not None:
        check(dims, m)
    return ShardPlan(mesh, dims)


def shard_batch(batch, mesh: Mesh | None):
    """This rank's rows of a global batch (a tuple of numpy arrays or
    tensors with the batch leading, e.g. a ``Batch``): the data-group
    rank's slice, the same for every rank of a model group. Raises when
    the batch does not split evenly."""
    if mesh is None or mesh.data_size == 1:
        return batch
    from uasr_torch.parallel.distributed import host_batch_slice

    start, size = host_batch_slice(len(batch[0]), mesh)
    rows = [x[start: start + size] for x in batch]
    return type(batch)(*rows) if hasattr(batch, "_fields") else type(batch)(rows)
