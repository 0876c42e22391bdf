"""What the generators share: the length distribution and the noise bank.

Lengths are the quantiles of a normal distribution (``mean_s``, ``sd_s``)
cut to [``min_s``, ``max_s``] at evenly spaced probabilities, so every seed
gets the same set of lengths and only their order differs. Audio is white
noise at ``amplitude`` cut from one bank drawn from the seed, each
utterance at its own seeded offset, zero past its length.
"""

from __future__ import annotations

import numpy as np

BANK_SAMPLES = 1 << 23


def quantiles(dist: dict, n: int, lo: float | None = None, hi: float | None = None) -> np.ndarray:
    """n lengths (seconds) at probabilities (i + 0.5) / n of the cut normal
    distribution, restricted further to (lo, hi] when given."""
    a, b = dist["min_s"], dist["max_s"]
    x = np.linspace(a, b, 200_001)
    pdf = np.exp(-0.5 * ((x - dist["mean_s"]) / dist["sd_s"]) ** 2)
    if lo is not None:
        pdf = np.where((x > lo) & (x <= hi), pdf, 0.0)
    cdf = np.cumsum(pdf)
    cdf /= cdf[-1]
    return np.interp((np.arange(n) + 0.5) / n, cdf, x)


def shares(dist: dict, edges: list[float]) -> np.ndarray:
    """The probability of each bucket (prev edge, edge] under the cut
    distribution."""
    x = np.linspace(dist["min_s"], dist["max_s"], 200_001)
    pdf = np.exp(-0.5 * ((x - dist["mean_s"]) / dist["sd_s"]) ** 2)
    lo = [-np.inf] + list(edges[:-1])
    p = np.array([pdf[(x > a) & (x <= b)].sum() for a, b in zip(lo, edges)])
    return p / p.sum()


def split(total: int, p: np.ndarray) -> np.ndarray:
    """``total`` items over shares ``p`` by largest remainder."""
    raw = total * p
    n = np.floor(raw).astype(int)
    n[np.argsort(-(raw - n), kind="stable")[: total - n.sum()]] += 1
    return n


def interleave(counts: np.ndarray) -> list[int]:
    """A sequence holding ``counts[k]`` of each k, spread evenly (each
    next item is the one furthest behind its share)."""
    total, seq = int(counts.sum()), []
    done = np.zeros(len(counts))
    for i in range(total):
        k = int(np.argmax(counts * (i + 1) / total - done))
        seq.append(k)
        done[k] += 1
    return seq


def noise_bank(rng: np.random.Generator, amplitude: float) -> np.ndarray:
    return (amplitude * rng.standard_normal(BANK_SAMPLES, dtype=np.float32)).astype(np.float32)
