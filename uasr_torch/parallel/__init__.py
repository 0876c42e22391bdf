"""Data, tensor and sequence parallelism over one process per device
(counterpart of ``uasr.parallel``): the mesh and the shard plan
(``mesh``), the process group (``distributed``) and the autograd-aware
collectives (``collectives``)."""

from uasr_torch.parallel.distributed import host_batch_slice, init_distributed, local_device
from uasr_torch.parallel.mesh import (
    Mesh, ShardPlan, make_mesh, param_shardings, shard_batch, shard_model,
)

__all__ = ["Mesh", "ShardPlan", "host_batch_slice", "init_distributed", "local_device",
           "make_mesh", "param_shardings", "shard_batch", "shard_model"]
