"""The ``cnn`` encoder per output frame: the strided Conv1d (k D H), the
other Conv1d layers and the two dilated ones (k H H each), the projection
(H V), two FLOPs a multiply-add. A streaming tick counts the logit frames
it decodes (the region of every decoding slot and the finishing slots'
last region); the window's replayed frames are not model work."""

from __future__ import annotations

import numpy as np


def enc_frames(frames, model: dict):
    """Only the first Conv1d is strided: ceil(frames / stride)."""
    return -(-np.asarray(frames) // model["conv_time_stride"])


def frame_flops(conf: dict) -> float:
    m, fe = conf["recipe"]["model"], conf["recipe"]["frontend"]
    k, H, D, V = m["conv_kernel"], m["hidden_size"], fe["num_mel_bins"], conf["vocab_size"]
    layers = max(m["num_conv_layers"], 1)
    return 2 * (k * D * H + (layers - 1 + 2) * k * H * H + H * V)


def call_flops(call: dict, conf: dict, loop: str) -> float:
    if "step_frames" in call:
        frames = call["step_frames"] + call["finish_frames"]
    else:
        frames = sum(call["enc_lengths"])
    f = frames * frame_flops(conf)
    return 3 * f if loop == "train" else f
