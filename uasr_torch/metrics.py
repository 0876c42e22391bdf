"""Structured metrics: JSONL + stdout (+ optional TensorBoard) (copy of
``uasr.metrics``).

The primary sink is a JSONL file (machine-readable, survives without
TensorBoard). With ``also_tensorboard`` (``train.tensorboard``) the same
scalars go to ``<directory>/tb`` through
``torch.utils.tensorboard.SummaryWriter`` as ``<tag>/<name>``; that export
is soft, as the JAX package's is without TensorFlow: when the writer
cannot be imported only metrics.jsonl is written.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any


class MetricWriter:
    def __init__(self, directory: str, also_tensorboard: bool = False):
        os.makedirs(directory, exist_ok=True)
        self.path = os.path.join(directory, "metrics.jsonl")
        self._f = open(self.path, "a")
        self._tb = None
        if also_tensorboard:
            try:  # optional: tensorboard is a separate package
                from torch.utils.tensorboard import SummaryWriter  # noqa: PLC0415

                self._tb = SummaryWriter(os.path.join(directory, "tb"))
            except Exception:
                self._tb = None

    def write(self, step: int, tag: str = "train", **scalars: Any) -> None:
        rec = {"step": int(step), "tag": tag, "time": time.time()}
        for k, v in scalars.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = v
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                try:
                    self._tb.add_scalar(f"{tag}/{k}", float(v), global_step=int(step))
                except (TypeError, ValueError):
                    pass
            self._tb.flush()

    def close(self) -> None:
        self._f.close()
        if self._tb is not None:
            self._tb.close()


def log_stdout(step: int, tag: str, **scalars) -> None:
    parts = " ".join(
        f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
        for k, v in scalars.items()
    )
    print(f"[{tag}] step {step}: {parts}", flush=True)
