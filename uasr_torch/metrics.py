"""Structured metrics: JSONL + stdout (copy of ``uasr.metrics``).

The primary sink is a JSONL file (machine-readable, survives without
TensorBoard). TensorBoard export is not ported: asking for it raises.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any


class MetricWriter:
    def __init__(self, directory: str, also_tensorboard: bool = False):
        if also_tensorboard:
            raise NotImplementedError(
                "train.tensorboard is not ported yet (ROADMAP.md Queue 1, item 15: aux); "
                "metrics.jsonl holds the same scalars")
        os.makedirs(directory, exist_ok=True)
        self.path = os.path.join(directory, "metrics.jsonl")
        self._f = open(self.path, "a")

    def write(self, step: int, tag: str = "train", **scalars: Any) -> None:
        rec = {"step": int(step), "tag": tag, "time": time.time()}
        for k, v in scalars.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = v
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()


def log_stdout(step: int, tag: str, **scalars) -> None:
    parts = " ".join(
        f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
        for k, v in scalars.items()
    )
    print(f"[{tag}] step {step}: {parts}", flush=True)
