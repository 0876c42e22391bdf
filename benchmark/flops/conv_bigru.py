"""conv2d front + BiGRU + output projection, per utterance of f valid
feature frames: Conv2D block i over ceil(f / 2^(i+1)) x ceil(D / 2^(i+1))
output positions (k^2 C_in C_out multiply-adds each); each GRU layer's two
directions, input and recurrent products (2 D 3H + 2 H 3H per frame and
direction); the projection 2 (2H) V per frame."""

from __future__ import annotations

import numpy as np


def _halve(n, s: int):
    """One Conv2D block's output length along an axis of stride ``s``."""
    return -(-n // s)


def enc_frames(frames, model: dict):
    """Every Conv2D block strides the time: ceil per block."""
    t = np.asarray(frames)
    for _ in range(model["num_conv_layers"]):
        t = _halve(t, model["conv_time_stride"])
    return t


def utterance_flops(f: int, conf: dict) -> float:
    m, fe = conf["recipe"]["model"], conf["recipe"]["frontend"]
    k, C, H, V = m["conv_kernel"], m["conv_channels"], m["hidden_size"], conf["vocab_size"]
    s, D = m["conv_time_stride"], fe["num_mel_bins"]
    total, t, d, c_in = 0.0, f, D, 1
    for _ in range(m["num_conv_layers"]):
        t, d = _halve(t, s), _halve(d, 2)
        total += t * d * 2 * k * k * c_in * C
        c_in = C
    width = C * d
    for i in range(m["num_gru_layers"]):
        din = width if i == 0 else 2 * H
        total += t * 2 * (2 * din * 3 * H + 2 * H * 3 * H)
    return total + t * 2 * (2 * H) * V


def call_flops(call: dict, conf: dict, loop: str) -> float:
    f = sum(utterance_flops(n, conf) for n in call["feat_lengths"])
    return 3 * f if loop == "train" else f
