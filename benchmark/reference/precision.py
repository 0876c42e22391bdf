"""Operand rounding for the reference's products.

``Cast("float32")`` leaves operands as they are; ``Cast("bfloat16")`` rounds
them to bfloat16; ``Cast("float8")`` rounds them to float8 e4m3 after a
per-tensor scale that maps the largest magnitude to 448, as a scaled fp8
product does. Products and sums stay in float32, so a rounded operand is
the only difference: that is the lower-precision control.
"""

from __future__ import annotations

import contextlib

import torch

FP8_MAX = 448.0


class Cast:
    def __init__(self, dtype: str = "float32"):
        if dtype not in ("float32", "bfloat16", "float8"):
            raise ValueError(f"unknown control precision {dtype!r}")
        self.dtype = dtype

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype == "float32":
            return x
        if self.dtype == "bfloat16":
            return x.to(torch.bfloat16).to(torch.float32)
        scale = x.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
        q = (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
        # straight-through: the rounding has no gradient of its own
        return x + (q - x).detach()


@contextlib.contextmanager
def no_tf32():
    """Full float32 products on the card inside (PyTorch allows TF32 for
    cuDNN's convolutions by default); the settings are restored after, so
    a program run later in the process runs as it would alone."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
