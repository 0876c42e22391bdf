"""Feature-space prep transforms for the wav2vec-U recipe: streaming PCA
and adjacent-cluster mean pooling (a numpy copy of
``uasr.data.transforms``).

The published wav2vec-U prep between the SSL model and the GAN (Baevski
et al. 2021) projects frame features with PCA (512 dims), then mean-pools
adjacent frames whose k-means cluster ids agree, so the generator sees
near-phone-rate inputs. These run once per corpus on the host, inside
``uasr_torch.tools.featurize``:

  - PCA is fit streaming (running sum and scatter matrix in float64), so
    the fit holds O(D^2) memory whatever the corpus length;
  - the pooling k-means is fit on a reservoir sample of frames (uniform
    without replacement over the stream, Algorithm R) with
    ``uasr_torch.ops.segment.kmeans_fit``;
  - fitted transforms are saved as .npz beside the cache, so dev and test
    splits reuse the train split's (``featurize --transforms-from``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np


class StreamingPCA:
    """Accumulate mean/scatter over a stream of [N, D] frame blocks,
    then finalize to the top-`dim` principal components."""

    def __init__(self):
        self.n = 0
        self._sum: np.ndarray | None = None
        self._scatter: np.ndarray | None = None

    def update(self, frames: np.ndarray) -> None:
        f = np.asarray(frames, np.float64)
        if f.ndim != 2:
            raise ValueError(f"expected [N, D] frames, got shape {f.shape}")
        if self._sum is None:
            d = f.shape[1]
            self._sum = np.zeros(d, np.float64)
            self._scatter = np.zeros((d, d), np.float64)
        self.n += f.shape[0]
        self._sum += f.sum(axis=0)
        self._scatter += f.T @ f

    def finalize(self, dim: int) -> "PCATransform":
        if self.n < 2:
            raise ValueError("need at least 2 frames to fit PCA")
        mean = self._sum / self.n
        cov = self._scatter / self.n - np.outer(mean, mean)
        d = mean.shape[0]
        if dim > d:
            raise ValueError(f"pca dim {dim} > feature dim {d}")
        evals, evecs = np.linalg.eigh(cov)  # ascending
        order = np.argsort(evals)[::-1][:dim]
        comps = evecs[:, order].T  # [dim, D]
        return PCATransform(
            mean=mean.astype(np.float32),
            components=comps.astype(np.float32),
            explained=np.maximum(evals[order], 0.0).astype(np.float32),
        )


@dataclass
class PCATransform:
    mean: np.ndarray        # [D]
    components: np.ndarray  # [dim, D]
    explained: np.ndarray   # [dim] eigenvalues (variance per component)

    def __call__(self, feats: np.ndarray) -> np.ndarray:
        return (np.asarray(feats, np.float32) - self.mean) @ self.components.T

    def save(self, path: str) -> None:
        np.savez(path, mean=self.mean, components=self.components,
                 explained=self.explained)

    @classmethod
    def load(cls, path: str) -> "PCATransform":
        z = np.load(path)
        return cls(mean=z["mean"], components=z["components"],
                   explained=z["explained"])


class Reservoir:
    """Uniform sample of up to `capacity` frames from a stream
    (Algorithm R, vectorized per block)."""

    def __init__(self, capacity: int, seed: int = 0):
        self.capacity = capacity
        self.rng = np.random.RandomState(seed)
        self.seen = 0
        self._buf: np.ndarray | None = None
        self._fill = 0

    def update(self, frames: np.ndarray) -> None:
        f = np.asarray(frames, np.float32)
        if self._buf is None:
            self._buf = np.empty((self.capacity, f.shape[1]), np.float32)
        i = 0
        # fill phase
        if self._fill < self.capacity:
            take = min(self.capacity - self._fill, f.shape[0])
            self._buf[self._fill : self._fill + take] = f[:take]
            self._fill += take
            self.seen += take
            i = take
        # replacement phase: element with global index t replaces a
        # random slot with probability capacity/(t+1)
        m = f.shape[0] - i
        if m > 0:
            idx = self.rng.randint(
                0, self.seen + 1 + np.arange(m), size=m
            )
            accept = np.nonzero(idx < self.capacity)[0]
            # later duplicates of the same slot must win (stream order)
            for j in accept:
                self._buf[idx[j]] = f[i + j]
            self.seen += m

    def sample(self) -> np.ndarray:
        if self._buf is None:
            return np.zeros((0, 0), np.float32)
        return self._buf[: self._fill].copy()


def assign_clusters(feats: np.ndarray, centroids: np.ndarray) -> np.ndarray:
    """Nearest-centroid ids on host. feats [T, D] -> [T] int32."""
    f = np.asarray(feats, np.float32)
    c = np.asarray(centroids, np.float32)
    d = (f * f).sum(1, keepdims=True) - 2.0 * (f @ c.T) + (c * c).sum(1)
    return d.argmin(1).astype(np.int32)


def pool_adjacent(feats: np.ndarray, ids: np.ndarray) -> np.ndarray:
    """Mean-pool runs of equal cluster id. feats [T, D], ids [T] ->
    pooled [S, D] with S = number of runs. The host-side counterpart of
    `uasr_torch.ops.segment.segment_pool` (which serves the on-device GAN
    frontend); this one runs once at prep time so the cached features
    are already phone-rate."""
    f = np.asarray(feats, np.float32)
    ids = np.asarray(ids)
    if f.shape[0] == 0:
        return f
    boundaries = np.nonzero(np.diff(ids))[0] + 1
    segs = np.split(f, boundaries)
    return np.stack([s.mean(0) for s in segs])


def save_kmeans(path: str, centroids: np.ndarray) -> None:
    np.savez(path, centroids=np.asarray(centroids, np.float32))


def load_kmeans(path: str) -> np.ndarray:
    return np.load(path)["centroids"]


PCA_FILE = "pca.npz"
KMEANS_FILE = "pool_kmeans.npz"


def load_transforms(directory: str):
    """Load whatever fitted transforms a previous featurize dump left in
    `directory`. Returns (PCATransform | None, centroids | None)."""
    pca = None
    km = None
    p = os.path.join(directory, PCA_FILE)
    if os.path.exists(p):
        pca = PCATransform.load(p)
    k = os.path.join(directory, KMEANS_FILE)
    if os.path.exists(k):
        km = load_kmeans(k)
    return pca, km
