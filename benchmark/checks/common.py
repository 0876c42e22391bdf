"""Gap measures shared by the checks."""

from __future__ import annotations

import statistics

import torch


def rel_rms(got: torch.Tensor, ref: torch.Tensor) -> float:
    """||got - ref|| / ||ref|| over the elements."""
    got, ref = got.double(), ref.double()
    return float((got - ref).norm() / ref.norm().clamp_min(1e-30)) if ref.numel() else 0.0


def worst_leaf(got: dict, ref: dict, counted: list[str]) -> tuple[float, str]:
    """The worst gap between two norms of a leaf, over the larger of the
    reference's norm of that leaf and of the median leaf."""
    med = statistics.median(ref[k] for k in counted)
    gaps = [(abs(got[k] - ref[k]) / max(ref[k], med, 1e-30), k) for k in counted]
    return max(gaps) if gaps else (0.0, "")


def counted_leaves(grad_ref: dict) -> list[str]:
    """Leaves whose reference gradient is at least a thousandth of the
    median leaf's: the others move under Adam by round-off alone."""
    med = statistics.median(grad_ref.values())
    return [k for k, v in grad_ref.items() if v >= 1e-3 * med]


def valid_rows(x: torch.Tensor, lengths) -> torch.Tensor:
    """[B, T, ...] -> the rows t < lengths[b], concatenated."""
    return torch.cat([x[b, : int(n)] for b, n in enumerate(lengths)])
