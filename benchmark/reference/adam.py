"""Global-norm clipping then Adam, and the recipes' learning-rate schedules.

The clip scales every gradient by max_norm / norm when the global norm is
at least max_norm (no eps); Adam has b1 0.9, b2 0.999, eps 1e-8 outside the
square root, bias correction by the update count; the schedule is called
with the number of updates made before this one. ``warmup_rsqrt``: lr *
min(s / warmup, sqrt(warmup / s)) with s = max(count, 1).
"""

from __future__ import annotations

import math

import torch


def schedule(train: dict):
    lr, warm = train["lr"], max(train.get("warmup_steps", 100), 1)
    kind = train.get("lr_schedule", "warmup_exp_decay")
    if kind == "constant":
        return lambda c: lr
    if kind == "warmup_rsqrt":
        return lambda c: lr * min(max(c, 1) / warm, math.sqrt(warm / max(c, 1)))
    rate, every = train.get("decay_rate", 0.96), max(train.get("decay_steps", 1000), 1)
    return lambda c: lr * min(c / warm, 1.0) * rate ** (max(c - warm, 0) / every)


class Adam:
    """From zero moments, or from ``state``: {"mu", "nu", "count"} (copied)."""

    def __init__(self, params: dict, train: dict, b1=0.9, b2=0.999, eps=1e-8,
                 state: dict | None = None):
        self.lr, self.clip = schedule(train), train.get("grad_clip", 5.0)
        self.b1, self.b2, self.eps = b1, b2, eps
        if state is None:
            self.mu = {k: torch.zeros_like(p) for k, p in params.items()}
            self.nu = {k: torch.zeros_like(p) for k, p in params.items()}
            self.count = 0
        else:
            self.mu = {k: state["mu"][k].detach().clone().float() for k in params}
            self.nu = {k: state["nu"][k].detach().clone().float() for k in params}
            self.count = int(state["count"])

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> float:
        """Update ``params`` in place; returns the unclipped global norm."""
        norm = math.sqrt(sum(float(g.double().pow(2).sum()) for g in grads.values()))
        scale = self.clip / norm if norm >= self.clip else 1.0
        lr = self.lr(self.count)
        self.count += 1
        c1, c2 = 1 - self.b1 ** self.count, 1 - self.b2 ** self.count
        for k, g in grads.items():
            g = g * scale
            self.mu[k].mul_(self.b1).add_((1 - self.b1) * g)
            self.nu[k].mul_(self.b2).add_((1 - self.b2) * g * g)
            params[k].sub_(lr * (self.mu[k] / c1) / ((self.nu[k] / c2).sqrt() + self.eps))
        return norm
