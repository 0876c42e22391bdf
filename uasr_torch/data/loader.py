"""Streaming disk loader (counterpart of ``uasr.data.loader``):
index-based bucketing, per-batch native decode.

It keeps only:

  - the utterance index (paths, token ids, lengths), a few MB for 1M
    utterances;
  - ONE decoded batch at a time, read by the threaded C++ WAV decoder
    (``uasr_torch/native/uasr_native.cpp``, ``batch_read_wavs_native``);
    wrap with ``uasr_torch.data.dataset.prefetch`` for a bounded
    look-ahead.

Audio lengths come from a header-only scan (no sample data read), or
from the ``<list>.lens`` sidecar that ``prepare lists / synth /
scan-lengths`` write, so bucketing never requires decoding. At the same
seed and arguments ``batches`` yields the JAX loader's batches in its
order (both draw from ``np.random.RandomState(seed)``).
"""

from __future__ import annotations

import os
import struct
import wave
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Sequence

import numpy as np

from uasr_torch.data.dataset import Batch
from uasr_torch.data.io import Utterance, read_utterance_list
from uasr_torch.native import batch_read_wavs_native
from uasr_torch.vocab import Vocab


def wav_header_info(path: str) -> tuple[int, int]:
    """(num_samples, sample_rate) from the WAV header only."""
    try:
        with wave.open(path, "rb") as w:
            return w.getnframes(), w.getframerate()
    except (wave.Error, struct.error, EOFError) as e:
        raise ValueError(f"{path}: unreadable wav header ({e})") from None


def scan_lengths(
    paths: Sequence[str], num_threads: int = 16
) -> tuple[np.ndarray, np.ndarray]:
    """Parallel header-only scan -> (num_samples [N], sample_rate [N])."""
    with ThreadPoolExecutor(max_workers=max(num_threads, 1)) as ex:
        infos = list(ex.map(wav_header_info, paths))
    ns = np.asarray([i[0] for i in infos], np.int64)
    sr = np.asarray([i[1] for i in infos], np.int32)
    return ns, sr


def read_length_sidecar(path: str) -> dict[str, tuple[int, int]] | None:
    """``<list>.lens`` length cache (written by ``prepare lists / synth /
    scan-lengths``): ``utt_id<TAB>num_samples<TAB>sample_rate`` per line.
    Returns None when the sidecar doesn't exist; malformed lines fail
    loudly (a silently skipped entry would trigger a full rescan)."""
    if not os.path.exists(path):
        return None
    table: dict[str, tuple[int, int]] = {}
    with open(path) as f:
        for ln in f:
            ln = ln.strip()
            if not ln or ln.startswith("#"):
                continue
            parts = ln.split("\t")
            if len(parts) != 3:
                raise ValueError(f"{path}: malformed length-cache line {ln!r}")
            table[parts[0]] = (int(parts[1]), int(parts[2]))
    return table


def write_length_sidecar(list_path: str, scan_threads: int = 16) -> str:
    """Header-scan every wav in ``list_path`` once and persist the result
    next to it; later ``StreamingASRDataset.from_file`` calls skip the
    scan entirely."""
    utts = read_utterance_list(list_path)
    ns, sr = scan_lengths([u.wav_path for u in utts], scan_threads)
    out = list_path + ".lens"
    with open(out, "w") as f:
        for u, n, r in zip(utts, ns, sr):
            f.write(f"{u.utt_id}\t{int(n)}\t{int(r)}\n")
    return out


class StreamingASRDataset:
    """Utterance list + vocab -> streamed ``Batch``es, flat RSS.

    Mirrors ``ASRDataset``'s list format; unlike it, ``batches()`` never
    holds more than one decoded batch.
    """

    def __init__(
        self,
        utts: list[Utterance],
        vocab: Vocab,
        sample_rate: int = 16000,
        scan_threads: int = 16,
        scanned: tuple[np.ndarray, np.ndarray] | None = None,
    ):
        self.utts = utts
        self.vocab = vocab
        self.sample_rate = sample_rate
        if scanned is not None:
            # precomputed (num_samples, rates), e.g. the .lens sidecar
            # written at prep time: skips the per-file header scan, which
            # costs minutes of I/O at the 1M-utterance scale on every run
            self.num_samples, rates = scanned
        else:
            paths = [u.wav_path for u in utts]
            self.num_samples, rates = scan_lengths(paths, scan_threads)
        bad = np.nonzero(rates != sample_rate)[0]
        if len(bad):
            raise ValueError(
                f"{utts[bad[0]].wav_path}: rate {rates[bad[0]]} != "
                f"{sample_rate} ({len(bad)} files total)"
            )
        self.labels = [vocab.encode(u.tokens) for u in utts]

    @classmethod
    def from_file(
        cls, path: str, vocab: Vocab, sample_rate: int = 16000, **kw
    ) -> "StreamingASRDataset":
        utts = read_utterance_list(path)
        if "scanned" not in kw:
            table = read_length_sidecar(path + ".lens")
            if table is not None and all(u.utt_id in table for u in utts):
                kw["scanned"] = (
                    np.asarray([table[u.utt_id][0] for u in utts], np.int64),
                    np.asarray([table[u.utt_id][1] for u in utts], np.int32),
                )
        return cls(utts, vocab, sample_rate, **kw)

    def __len__(self) -> int:
        return len(self.utts)

    def batches(
        self,
        batch_size: int,
        max_audio_samples: int,
        max_label_len: int,
        seed: int = 0,
        shuffle: bool = True,
        shuffle_buffer: int = 0,
        drop_remainder: bool = True,
        num_epochs: int | None = None,
        bucket_boundaries: Sequence[int] = (),
        decode_threads: int = 0,
        on_decode=None,
    ) -> Iterator[Batch]:
        """Shuffle indices -> bucket by scanned length -> decode ONE batch
        via the native reader -> yield.

        ``shuffle_buffer`` > 0 and < N switches to a window shuffle (the
        reference's tf.data ``shuffle(buffer_size)``): cheaper state for
        huge corpora at slightly less mixing. ``on_decode`` is a test hook
        called once per decoded batch.
        """
        if not bucket_boundaries:
            bucket_boundaries = (max_audio_samples,)
        bounds = sorted(int(b) for b in bucket_boundaries)
        rng = np.random.RandomState(seed)
        N = len(self.utts)
        epoch = 0
        while num_epochs is None or epoch < num_epochs:
            order = _index_stream(N, rng, shuffle, shuffle_buffer)
            buckets: dict[int, list[int]] = {b: [] for b in bounds}
            for i in order:
                L = int(min(self.num_samples[i], max_audio_samples))
                b = _bucket(L, bounds)
                buckets[b].append(i)
                if len(buckets[b]) == batch_size:
                    yield self._decode(
                        buckets[b], b, max_label_len, decode_threads, on_decode
                    )
                    buckets[b] = []
            if not drop_remainder:
                for b, idxs in buckets.items():
                    if idxs:
                        yield self._decode(
                            idxs, b, max_label_len, decode_threads, on_decode
                        )
            epoch += 1

    def _decode(
        self, idxs: list[int], audio_len: int, max_label_len: int,
        decode_threads: int, on_decode,
    ) -> Batch:
        paths = [self.utts[i].wav_path for i in idxs]
        audio, lengths, rates = batch_read_wavs_native(
            paths, audio_len, num_threads=decode_threads
        )
        failed = np.nonzero(lengths < 0)[0]
        if len(failed):
            raise ValueError(f"{paths[failed[0]]}: wav decode failed")
        bad = np.nonzero(rates != self.sample_rate)[0]
        if len(bad):
            raise ValueError(
                f"{paths[bad[0]]}: rate {rates[bad[0]]} != {self.sample_rate}"
            )
        B = len(idxs)
        labels = np.zeros((B, max_label_len), np.int32)
        l_len = np.zeros((B,), np.int32)
        for j, i in enumerate(idxs):
            ids = self.labels[i][:max_label_len]
            labels[j, : len(ids)] = ids
            l_len[j] = len(ids)
        batch = Batch(audio, lengths.astype(np.int32), labels, l_len)
        if on_decode is not None:
            on_decode(batch)
        return batch


def _bucket(n: int, bounds: Sequence[int]) -> int:
    for b in bounds:
        if n <= b:
            return b
    return bounds[-1]


def _index_stream(
    N: int, rng: np.random.RandomState, shuffle: bool, buffer: int
) -> Iterator[int]:
    if not shuffle:
        yield from range(N)
        return
    if buffer <= 0 or buffer >= N:
        order = np.arange(N)
        rng.shuffle(order)
        yield from order.tolist()
        return
    # window shuffle over a sequential scan (tf.data shuffle(buffer_size))
    window = list(range(buffer))
    nxt = buffer
    while window:
        j = int(rng.randint(len(window)))
        yield window[j]
        if nxt < N:
            window[j] = nxt
            nxt += 1
        else:
            window[j] = window[-1]
            window.pop()
