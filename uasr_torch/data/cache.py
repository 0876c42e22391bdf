"""Precomputed-feature cache (counterpart of ``uasr.data.cache``; numpy,
with the device-resident corpus on torch tensors).

Two cases keep a cache worth its place: features made elsewhere (SSL /
wav2vec features for the wav2vec-U recipe, ``prepare import-features``,
or the port's own ``tools.featurize`` dump), and storage too slow to
decode wavs every epoch.

Format (the JAX package's, so either package reads the other's caches):
sharded ``.npz`` files, each holding ``feat_<i>`` float32 [T_i, D] and
``ids_<i>`` int32 label arrays, plus an ``index.json``.
"""

from __future__ import annotations

import json
import os
import time
from typing import Iterator, Sequence

import numpy as np
import torch

from uasr_torch import resolve_device
from uasr_torch.data.dataset import Batch

# what the last device_feature_batches uploaded: the corpus's bytes on the
# device and the seconds the upload took (set once per call)
LAST_DEVICE_CORPUS: dict = {}


def write_cache(out_dir: str, examples: Iterator[tuple[str, np.ndarray, Sequence[int]]],
                shard_size: int = 512) -> None:
    """Write (utt_id, feats [T, D], label ids) examples as a cache."""
    os.makedirs(out_dir, exist_ok=True)
    index = []
    shard: dict[str, np.ndarray] = {}
    shard_utts: list[str] = []

    def flush():
        nonlocal shard, shard_utts
        if not shard_utts:
            return
        path = os.path.join(out_dir, f"shard_{len(index):05d}.npz")
        np.savez_compressed(path, **shard)
        index.append({"path": os.path.basename(path), "utts": shard_utts})
        shard, shard_utts = {}, []

    for utt_id, feat, ids in examples:
        i = len(shard_utts)
        shard[f"feat_{i}"] = np.asarray(feat, np.float32)
        shard[f"ids_{i}"] = np.asarray(list(ids), np.int32)
        shard_utts.append(utt_id)
        if len(shard_utts) >= shard_size:
            flush()
    flush()
    with open(os.path.join(out_dir, "index.json"), "w") as f:
        json.dump(index, f)


class FeatureCache:
    """Reader over a cache directory; iterates (utt_id, feat, ids)."""

    def __init__(self, directory: str):
        self.directory = directory
        with open(os.path.join(directory, "index.json")) as f:
            self.index = json.load(f)
        self.utts = [(s, i) for s, rec in enumerate(self.index) for i in range(len(rec["utts"]))]
        self._shard_cache: dict[int, np.lib.npyio.NpzFile] = {}

    def __len__(self):
        return len(self.utts)

    @property
    def dim(self) -> int:
        """D, the width of every feature frame."""
        return int(self.example(0)[1].shape[1])

    def _shard(self, s: int):
        if s not in self._shard_cache:
            self._shard_cache[s] = np.load(os.path.join(self.directory, self.index[s]["path"]))
        return self._shard_cache[s]

    def example(self, i: int) -> tuple[str, np.ndarray, list[int]]:
        s, j = self.utts[i]
        z = self._shard(s)
        return self.index[s]["utts"][j], z[f"feat_{j}"], z[f"ids_{j}"].tolist()

    def __iter__(self):
        for i in range(len(self)):
            yield self.example(i)


def feature_batch_iterator(cache: FeatureCache, batch_size: int, max_frames: int,
                           max_label_len: int, seed: int = 0, num_epochs: int | None = None,
                           shuffle: bool = True, drop_remainder: bool = True):
    """Padded feature batches read from the cache on the host: ``Batch``es
    whose ``audio`` holds [B, max_frames, D] features and whose
    ``audio_lengths`` count frames (the trainers then bypass the
    frontend). The JAX package's order for the same seed."""
    D = cache.example(0)[1].shape[1]
    rng = np.random.RandomState(seed)
    epoch = 0

    def make(idxs):
        B = len(idxs)
        feats = np.zeros((B, max_frames, D), np.float32)
        flen = np.zeros((B,), np.int32)
        labels = np.zeros((B, max_label_len), np.int32)
        llen = np.zeros((B,), np.int32)
        for j, i in enumerate(idxs):
            _, f, ids = cache.example(int(i))
            n = min(len(f), max_frames)
            feats[j, :n] = f[:n]
            flen[j] = n
            u = min(len(ids), max_label_len)
            labels[j, :u] = ids[:u]
            llen[j] = u
        return Batch(feats, flen, labels, llen)

    while num_epochs is None or epoch < num_epochs:
        order = np.arange(len(cache))
        if shuffle:
            rng.shuffle(order)
        stop = len(order) if not drop_remainder else len(order) - batch_size + 1
        for s in range(0, max(stop, 0), batch_size):
            yield make(order[s: s + batch_size])
        epoch += 1


def device_feature_batches(cache, batch_size: int, max_frames: int, max_label_len: int,
                           seed: int = 0, num_epochs: int | None = None, shuffle: bool = True,
                           drop_remainder: bool = True, device="cuda"):
    """``feature_batch_iterator`` with the corpus resident on ``device``:
    the padded [N, T, D] corpus (T the corpus's longest utterance, capped
    at ``max_frames``) is uploaded once, and each batch is a row gather on
    the device, so per step the host sends only the [B] indices. Batches
    hold tensors on ``device`` (features f32, lengths and labels int64),
    one shape for every batch. A final partial batch (``drop_remainder``
    False) is padded to ``batch_size`` by repeating row 0 with zero
    lengths. ``cache`` is a ``FeatureCache`` or a list of (feats [T, D],
    ids) pairs (the self-training student corpus). The upload's bytes and
    seconds land in ``LAST_DEVICE_CORPUS``."""
    device = resolve_device(device)
    if isinstance(cache, (list, tuple)):
        get = lambda i: cache[i]  # noqa: E731
    else:
        get = lambda i: cache.example(i)[1:]  # noqa: E731
    N = len(cache)
    D = get(0)[0].shape[1]
    tmax = min(max(max(len(get(i)[0]) for i in range(N)), 1), max_frames)
    feats = np.zeros((N, tmax, D), np.float32)
    flen = np.zeros((N,), np.int64)
    labels = np.zeros((N, max_label_len), np.int64)
    llen = np.zeros((N,), np.int64)
    for i in range(N):
        f, ids = get(i)
        n = min(len(f), tmax)
        feats[i, :n] = f[:n]
        flen[i] = n
        u = min(len(ids), max_label_len)
        labels[i, :u] = ids[:u]
        llen[i] = u
    t0 = time.perf_counter()
    corpus = tuple(torch.from_numpy(x).to(device) for x in (feats, flen, labels, llen))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    LAST_DEVICE_CORPUS.clear()
    LAST_DEVICE_CORPUS.update(bytes=sum(x.numel() * x.element_size() for x in corpus),
                              upload_s=time.perf_counter() - t0, shape=(N, tmax, D))
    del feats, labels

    rng = np.random.RandomState(seed)
    epoch = 0
    while num_epochs is None or epoch < num_epochs:
        order = np.arange(N)
        if shuffle:
            rng.shuffle(order)
        stop = N if not drop_remainder else N - batch_size + 1
        for s in range(0, max(stop, 0), batch_size):
            idx = order[s: s + batch_size]
            n = len(idx)
            if n < batch_size:  # only without drop_remainder
                idx = np.concatenate([idx, np.zeros(batch_size - n, np.int64)])
            f, fl, la, ll = (x.index_select(0, torch.from_numpy(idx).to(device))
                             for x in corpus)
            if n < batch_size:
                live = torch.arange(batch_size, device=device) < n
                fl, ll = torch.where(live, fl, 0), torch.where(live, ll, 0)
            yield Batch(f, fl, la, ll)
        epoch += 1
