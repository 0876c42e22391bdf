"""Model FLOPs for the ``mfu`` metrics: the encoder's and the output
projection's products over the valid frames (the frontend left out), x3
for a training step (forward, and the backward's two products).

Each ``<encoder>.py`` also holds ``enc_frames(frames, model)``, the
encoder's frames for a number of feature frames; ``enc_frames`` here
finds it by the recipe's ``model.encoder``, so shared code names no
encoder."""

from __future__ import annotations


def enc_frames(frames, model: dict):
    """Encoder frames of ``frames`` feature frames (a number or an array)
    under the recipe's ``model`` section."""
    from benchmark.core import files

    return files.module("flops", model["encoder"]).enc_frames(frames, model)
