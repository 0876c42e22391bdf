"""A backlog of streamed utterances for a fixed number of serving slots.

Parameters: ``slots``, ``utterances`` in the backlog (taken in a cycle),
``lengths`` (the cut normal of ``common``), ``amplitude``. The backlog's
lengths are the same quantiles for every seed; the seed orders them and
draws the audio, each utterance a slice of the noise bank at its own
offset. Returns a ``Backlog``.
"""

from __future__ import annotations

import numpy as np

from benchmark.traffic.common import noise_bank, quantiles


class Backlog:
    def __init__(self, bank: np.ndarray, offsets: np.ndarray, samples: np.ndarray):
        self.bank, self.offsets, self.samples = bank, offsets, samples

    def __len__(self) -> int:
        return len(self.samples)

    def audio(self, u: int) -> np.ndarray:
        o = int(self.offsets[u])
        return self.bank[o: o + int(self.samples[u])]

    def chunk_into(self, out: np.ndarray, u: int, k: int) -> None:
        """Write chunk k of utterance u into ``out`` (zero past its end)."""
        S = out.shape[0]
        a, n = k * S, int(self.samples[u])
        m = max(min(S, n - a), 0)
        o = int(self.offsets[u]) + a
        out[:m] = self.bank[o: o + m]
        out[m:] = 0.0


def generate(p: dict, seed: int, sample_rate: int = 16000) -> Backlog:
    rng = np.random.default_rng(seed)
    secs = rng.permutation(quantiles(p["lengths"], p["utterances"]))
    samples = (secs * sample_rate).astype(np.int64)
    bank = noise_bank(rng, p["amplitude"])
    offsets = rng.integers(0, len(bank) - samples.max(), len(samples))
    return Backlog(bank, offsets, samples)
