"""Process-group initialisation and the host's slice of a batch
(counterpart of ``uasr.parallel.distributed``).

One process per device, launched by ``torchrun``:

    torchrun --nproc-per-node 8 -m uasr_torch.cli -c configs/X.yaml --mode train

``init_distributed`` reads torchrun's environment (``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, ``LOCAL_RANK``), sets
the rank's device to ``cuda:LOCAL_RANK`` and joins the group: NCCL for
CUDA, gloo for the CPU, or the backend the caller names (a rehearsal of
several ranks on one card runs gloo with every ``LOCAL_RANK`` 0, since
NCCL refuses two ranks on one device). A failed initialisation raises.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

TIMEOUT_S = 600.0  # a collective that waits longer raises


def init_distributed(device: str = "cuda", backend: str | None = None) -> bool:
    """Join the process group torchrun describes; a no-op that returns
    False for one process (``WORLD_SIZE`` unset or 1). ``device`` "cuda"
    sets the rank's device to ``cuda:LOCAL_RANK`` and defaults the backend
    to NCCL, "cpu" to gloo. A collective that waits past ``TIMEOUT_S``
    raises."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return False
    if dist.is_initialized():
        return True
    kind = torch.device(device).type
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed(device='cuda') but no card is present; "
                               "pass device='cpu' for a gloo group on the CPU")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    backend = backend or ("nccl" if kind == "cuda" else "gloo")
    dist.init_process_group(backend, init_method="env://", world_size=world,
                            rank=int(os.environ["RANK"]),
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return True


def local_device(device: str = "cuda") -> torch.device:
    """This rank's device: ``cuda:LOCAL_RANK`` for "cuda", else the CPU."""
    if torch.device(device).type == "cuda":
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return torch.device(device)


def host_batch_slice(global_batch_size: int, mesh=None) -> tuple[int, int]:
    """(start, size) of this rank's rows of the global batch: its
    data-group rank's slice (the whole batch without a mesh)."""
    n = 1 if mesh is None else mesh.data_size
    i = 0 if mesh is None else mesh.data_rank
    if global_batch_size % n:
        raise ValueError(f"global batch {global_batch_size} % data ranks {n} != 0")
    per = global_batch_size // n
    return i * per, per
