"""PyTorch/CUDA port of tpu-uasr.

A second package beside the JAX package ``uasr``, which stays the
reference it is held against. The port imports torch and numpy, never
jax, flax or anything of ``uasr``; where it needs a framework-free
module of the JAX package it keeps its own copy.

Each TPU kernel on a ported path has a hand-written CUDA kernel under
``uasr_torch/csrc/`` and a plain PyTorch version of the same function
beside its wrapper. A wrapper launches the kernel for CUDA tensors and
runs the plain version only for CPU tensors. Entry points default to
``device="cuda"`` and raise when no card is present; tests pass
``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; raises if CUDA is asked for and no
    card is present (the port never drops to the CPU by itself)."""
    if isinstance(device, (list, tuple)):
        raise NotImplementedError(
            "one process drives one device: for multi-device decode or training launch one "
            "process per device with torchrun and pass the entry points a mesh "
            "(uasr_torch.parallel.init_distributed, make_mesh); pass one device here"
        )
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch versions"
        )
    return device
