"""Checkpointing with the JAX package's semantics, on ``torch.save``
(counterpart of ``uasr.checkpoint``).

Contract kept: directory-per-config, keep the newest N
(``max_to_keep``), restore the newest into the structure of a template
state (resume), restore a given retained step, average the newest N
(``restore_averaged``), and a structure-mismatch error that names the
likely cause. A state is a tree of NamedTuples, dicts, lists and tuples
whose leaves are tensors or Python numbers.

Each checkpoint is one file, ``<dir>/<step>.pt``, written to a temporary
name and renamed into place, so a kill never leaves half a checkpoint.
Saves are synchronous, so ``wait`` and ``close`` have nothing to wait
for. Orbax checkpoints of the JAX package are not readable here; weights
move across through ``uasr_torch.convert.flax_to_state_dict``.
"""

from __future__ import annotations

import os
import re
from typing import Any

import torch

_NAME = re.compile(r"^(\d+)\.pt$")


def _items(tree):
    if hasattr(tree, "_fields"):  # NamedTuple
        return list(zip(tree._fields, tree))
    if isinstance(tree, dict):
        return list(tree.items())
    if isinstance(tree, (list, tuple)):
        return list(enumerate(tree))
    return None


def flatten(tree, prefix: str = "") -> dict[str, Any]:
    """Leaves of a state tree by path ("params/bigru0.wx", "step", ...)."""
    items = _items(tree)
    if items is None:
        if not isinstance(tree, (torch.Tensor, int, float, bool)):
            raise TypeError(f"checkpoint leaf {prefix!r} has unsupported type {type(tree)}")
        return {prefix: tree}
    out: dict[str, Any] = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def unflatten(template, flat: dict[str, Any], prefix: str = ""):
    """A tree shaped like ``template`` with the leaves of ``flat``; tensors
    land on the template leaf's device."""
    items = _items(template)
    if items is None:
        v = flat[prefix]
        if isinstance(template, torch.Tensor):
            return v.to(device=template.device, dtype=template.dtype)
        return type(template)(v)
    vals = [unflatten(t, flat, f"{prefix}/{k}" if prefix else str(k)) for k, t in items]
    if hasattr(template, "_fields"):
        return type(template)(*vals)
    if isinstance(template, dict):
        return dict(zip(template.keys(), vals))
    return type(template)(vals)


def _signature(flat: dict[str, Any]) -> dict[str, tuple]:
    return {k: (tuple(v.shape), v.dtype) if isinstance(v, torch.Tensor) else (type(v).__name__,)
            for k, v in flat.items()}


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int | None = 5):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"{int(step)}.pt")

    def save(self, step: int, state: Any) -> None:
        """Save ``state`` as ``step``; a step already saved is kept as it
        is (as Orbax skips it). Then drop all but the newest
        ``max_to_keep``."""
        path = self._path(step)
        if os.path.exists(path):
            return
        leaves = {k: v.detach().cpu() if isinstance(v, torch.Tensor) else v
                  for k, v in flatten(state).items()}
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save({"step": int(step), "leaves": leaves}, tmp)
        os.replace(tmp, path)
        if self.max_to_keep:
            for old in self.all_steps()[: -self.max_to_keep]:
                os.remove(self._path(old))

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> list[int]:
        return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(self.directory)) if m)

    def restore(self, step: int, abstract_state: Any) -> Any:
        """Restore a retained step (see ``all_steps``) into the structure
        of ``abstract_state``."""
        blob = torch.load(self._path(step), map_location="cpu", weights_only=True)
        leaves = blob["leaves"]
        want = _signature(flatten(abstract_state))
        if _signature(leaves) != want:
            missing = sorted(set(want) - set(leaves))[:5]
            extra = sorted(set(leaves) - set(want))[:5]
            differ = sorted(k for k in set(want) & set(leaves)
                            if _signature({k: leaves[k]})[k] != want[k])[:5]
            raise ValueError(
                f"checkpoint at step {step} under {self.directory!r} has a different state "
                "structure than the current config builds (typical causes: train.grad_accum "
                "or optimizer/model hyperparameters changed since the run was saved). Resume "
                "with the original settings or start a fresh model_dir. Missing leaves "
                f"{missing}, unexpected {extra}, different shape or dtype {differ}")
        return unflatten(abstract_state, leaves)

    def restore_latest(self, abstract_state: Any) -> tuple[Any, int] | None:
        """(state, step) of the newest checkpoint, or None if there is none."""
        step = self.latest_step()
        if step is None:
            return None
        return self.restore(step, abstract_state), step

    def wait(self) -> None:
        """Saves are synchronous: nothing is in flight."""

    def close(self) -> None:
        """Saves are synchronous: nothing to flush."""


def restore_averaged(mgr: CheckpointManager, abstract_state: Any,
                     last_n: int) -> tuple[Any, int] | None:
    """Restore the newest ``last_n`` retained checkpoints and average their
    float leaves in float64 on the host (checkpoint averaging); other
    leaves (step counters, integer state) come from the newest. Uses every
    retained step when fewer exist. Returns (state, newest step) or None."""
    steps = mgr.all_steps()
    if not steps:
        return None
    take = steps[-max(int(last_n), 1):]
    cpu_template = unflatten(abstract_state, {k: v.detach().cpu() if isinstance(v, torch.Tensor)
                                              else v for k, v in flatten(abstract_state).items()})
    acc: dict[str, torch.Tensor] = {}
    newest: dict[str, Any] = {}
    for s in take:
        newest = flatten(mgr.restore(s, cpu_template))
        for k, v in newest.items():
            if isinstance(v, torch.Tensor) and v.is_floating_point():
                acc[k] = acc[k] + v.double() if k in acc else v.double()
    out = {k: (acc[k] / len(take)).to(v.dtype) if k in acc else v for k, v in newest.items()}
    return unflatten(abstract_state, out), int(take[-1])
