"""What the loops share: the program's configuration from a recipe, the
frame arithmetic of the recipes' frontends (an encoder's is in its
``flops/<encoder>.py``), the percentile."""

from __future__ import annotations

import dataclasses

import numpy as np

from benchmark.flops import enc_frames


def program_config(conf: dict, seed: int):
    """The port's ``Config`` of a configuration file's recipe, its stand-in
    vocabulary size, and ``train.seed`` from the run's seed."""
    from uasr_torch.config import Config, _build

    cfg = _build(Config, conf["recipe"]).replace(vocab_size=conf["vocab_size"])
    return cfg.replace(train=dataclasses.replace(cfg.train, seed=int(seed) % (2 ** 31)))


def feat_frames(samples, fe: dict):
    """Frames of the utterance frontend: 1 + (L - 400) // 160, at least 1."""
    fl = int(round(fe.get("sample_rate", 16000) * fe.get("frame_length_ms", 25.0) / 1000))
    fs = int(round(fe.get("sample_rate", 16000) * fe.get("frame_shift_ms", 10.0) / 1000))
    return np.maximum(1 + (np.asarray(samples) - fl) // fs, 1)


def sync(device) -> None:
    """Wait for the device's queued work (nothing to wait for on the CPU)."""
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def percentile(values, q: float) -> float:
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def batch_meta(batch, conf: dict) -> dict:
    """The shapes of one bucketed batch, for the readers."""
    audio, alen, labels, llen = batch
    fe, model = conf["recipe"]["frontend"], conf["recipe"]["model"]
    ff = feat_frames(alen, fe)
    T = int(feat_frames(audio.shape[1], fe))
    return {"B": int(audio.shape[0]), "L": int(audio.shape[1]), "T_feat": T,
            "T_enc": int(enc_frames(T, model)), "feat_lengths": ff.tolist(),
            "enc_lengths": enc_frames(ff, model).tolist(),
            "label_lengths": np.asarray(llen).tolist(), "U": int(labels.shape[1]),
            "audio_s": float(np.sum(alen)) / fe.get("sample_rate", 16000)}
