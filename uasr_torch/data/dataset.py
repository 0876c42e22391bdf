"""Datasets and batching (counterpart of ``uasr.data.dataset``).

Copies of the JAX package's host-side data layer, which is numpy only:

  - ``ASRDataset``: utterance list + vocab -> (audio, ids) examples;
  - ``batch_iterator``: shuffle -> bucket by audio length -> pad, so a
    step sees one of a small static set of shapes;
  - ``prefetch``: a background thread that keeps batches ready;
  - ``TextDataset`` and ``text_batch_iterator``: the unpaired token-id
    text of the GAN's real side and EODM's statistics, batched with the
    JAX package's numpy order (the same batches for the same seed);
  - the synthetic "tone language" corpus (phone k is a pure tone) and its
    formant-style variant, for tests and smoke runs without downloads.

The streaming loader, Kaldi archives, feature transforms and feature
caches are not ported yet (ROADMAP.md Queue 1).
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator, NamedTuple, Sequence

import numpy as np

from uasr_torch.data.io import Utterance, read_utterance_list, read_wav
from uasr_torch.vocab import Vocab, make_vocab


class Batch(NamedTuple):
    audio: np.ndarray  # [B, L] float32 (or [B, T, D] precomputed features)
    audio_lengths: np.ndarray  # [B] int32
    labels: np.ndarray  # [B, U] int32
    label_lengths: np.ndarray  # [B] int32


class TextBatch(NamedTuple):
    ids: np.ndarray  # [B, U] int32
    lengths: np.ndarray  # [B] int32


@dataclass
class ASRDataset:
    """Utterance list + vocab -> (audio, ids) examples."""

    utts: list[Utterance]
    vocab: Vocab
    sample_rate: int = 16000

    @classmethod
    def from_file(cls, path: str, vocab: Vocab, sample_rate: int = 16000):
        return cls(read_utterance_list(path), vocab, sample_rate)

    def __len__(self):
        return len(self.utts)

    def example(self, i: int) -> tuple[np.ndarray, list[int]]:
        u = self.utts[i]
        audio, sr = read_wav(u.wav_path)
        if sr != self.sample_rate:
            raise ValueError(f"{u.wav_path}: rate {sr} != {self.sample_rate}")
        return audio, self.vocab.encode(u.tokens)


@dataclass
class TextDataset:
    """Unpaired token-id sequences (GAN real side / EODM statistics)."""

    sequences: list[list[int]]

    @classmethod
    def from_file(cls, path: str, vocab: Vocab):
        seqs = []
        with open(path) as f:
            for ln in f:
                toks = ln.split()
                if toks:
                    seqs.append(vocab.encode(toks))
        return cls(seqs)


# ------------------------------------------------------------- synthetic


def synth_tone_audio(
    ids: Sequence[int],
    sample_rate: int = 16000,
    frames_per_phone: tuple[int, int] = (8, 16),
    noise: float = 0.02,
    rng: np.random.RandomState | None = None,
) -> np.ndarray:
    """Synthesize audio where phone k is a tone at 250 + 90*k Hz with a
    random duration — a learnable toy language for tests/benches."""
    rng = rng or np.random.RandomState(0)
    hop = 160  # one frame @ 10ms/16k
    pieces = []
    phase = 0.0
    for k in ids:
        n = int(rng.randint(frames_per_phone[0], frames_per_phone[1] + 1)) * hop
        f = 250.0 + 90.0 * int(k)
        t = np.arange(n)
        seg = 0.4 * np.sin(phase + 2 * np.pi * f * t / sample_rate)
        phase += 2 * np.pi * f * n / sample_rate
        pieces.append(seg)
    audio = np.concatenate(pieces) if pieces else np.zeros(hop)
    return (audio + noise * rng.randn(len(audio))).astype(np.float32)


def _phone_formants(num_phones: int) -> np.ndarray:
    """Fixed per-phone formant table [P, 3] in Hz. Deterministic (the
    language, not the data): formants are spread over vowel-like ranges
    with a per-phone scramble so adjacent phone ids are NOT adjacent in
    formant space."""
    rng = np.random.RandomState(777)
    P = num_phones
    f1 = 280.0 + 620.0 * rng.permutation(P) / max(P - 1, 1)
    f2 = 950.0 + 1500.0 * rng.permutation(P) / max(P - 1, 1)
    f3 = 2400.0 + 900.0 * rng.permutation(P) / max(P - 1, 1)
    return np.stack([f1, f2, f3], axis=1)


def synth_formant_audio(
    ids: Sequence[int],
    num_phones: int,
    sample_rate: int = 16000,
    frames_per_phone: tuple[int, int] = (8, 16),
    noise: float = 0.05,
    rng: np.random.RandomState | None = None,
) -> np.ndarray:
    """Formant-style phone synthesis — the HARD quality stand-in corpus
    (round-4, VERDICT round-3 weak #6: pure tones let CPC win by
    tracking deterministic phase, and chance/PER anchors said little
    about TIMIT-like difficulty).

    Each phone k is 2-3 NARROWBAND NOISE bands at fixed per-phone
    formant frequencies (`_phone_formants`): cos(2π f t + φ(t)) with
    φ(t) a Brownian phase walk, so there is no deterministic phase to
    track — only spectral envelope identity, like real speech. Per
    utterance: a speaker factor (all formants scaled by ~N(1, 0.06)),
    a spectral tilt (channel), and a broadband noise floor. Amplitude
    envelopes rise/fall per phone so boundaries are smooth.

    Same contract as `synth_tone_audio`.
    """
    rng = rng or np.random.RandomState(0)
    hop = 160
    formants = _phone_formants(num_phones)
    speaker = 1.0 + 0.06 * rng.randn()  # vocal-tract length factor
    tilt_db_per_khz = rng.uniform(-2.0, 2.0)  # channel tilt
    band_amps = np.array([1.0, 0.6, 0.3])
    pieces = []
    phase = rng.uniform(0, 2 * np.pi, size=3)
    for k in ids:
        # 1-indexed phone ids (0 = blank) -> formant row
        row = formants[(int(k) - 1) % num_phones] * speaker
        n = int(rng.randint(frames_per_phone[0],
                            frames_per_phone[1] + 1)) * hop
        t = np.arange(n)
        seg = np.zeros(n)
        for j, (f, a) in enumerate(zip(row, band_amps)):
            f = min(f, 0.45 * sample_rate)
            # Brownian phase walk: ~80 Hz bandwidth around the formant
            dphi = (2 * np.pi * f / sample_rate
                    + 0.12 * rng.randn(n))
            ph = phase[j] + np.cumsum(dphi)
            phase[j] = ph[-1]
            gain = a * 10.0 ** (tilt_db_per_khz * (f / 1000.0) / 20.0)
            seg += gain * np.cos(ph)
        # smooth rise/fall envelope (10 ms) at phone boundaries
        ramp = min(160, n // 4)
        env = np.ones(n)
        env[:ramp] = np.linspace(0.2, 1.0, ramp)
        env[-ramp:] = np.linspace(1.0, 0.2, ramp)
        pieces.append(0.25 * seg * env)
    audio = np.concatenate(pieces) if pieces else np.zeros(hop)
    return (audio + noise * rng.randn(len(audio))).astype(np.float32)


def synthetic_phonotactics(num_phones: int, seed: int = 1234) -> np.ndarray:
    """A fixed sparse Markov transition matrix over phones (zero
    diagonal), the synthetic language's 'phonotactics'.

    Identifiability matters: with IID phone strings, bigram statistics
    factor as p(a)p(b), so any frequency-preserving permutation of the
    phone inventory matches the text distribution equally well and NO
    distribution-matching objective (EODM / GAN) can recover the true
    mapping. A Markov grammar with distinct successor distributions per
    phone breaks that symmetry — like real phonotactics do.

    Dense-Dirichlet below 20 phones; at TIMIT-scale inventories each
    phone keeps only its top max(8, P//3) successors (hard zeros
    elsewhere — real phonotactics forbid most bigrams)."""
    rng = np.random.RandomState(seed)  # fixed: the language, not the data
    trans = rng.dirichlet(0.3 * np.ones(num_phones), size=num_phones)
    np.fill_diagonal(trans, 0.0)
    if num_phones >= 20 and max(8, num_phones // 3) < num_phones - 1:
        k = max(8, num_phones // 3)
        # zero everything below each row's k-th largest successor
        kth = np.sort(trans, axis=1)[:, -k][:, None]
        trans = np.where(trans >= kth, trans, 0.0)
    return trans / trans.sum(axis=1, keepdims=True)


def sample_phone_string(n: int, trans: np.ndarray, rng: np.random.RandomState) -> list[int]:
    """Sample a length-n phone-id string (ids 1..P) from the grammar,
    the first phone uniform."""
    P = trans.shape[0]
    ids = [int(rng.choice(P, p=np.full(P, 1.0 / P)))]
    for _ in range(n - 1):
        ids.append(int(rng.choice(P, p=trans[ids[-1]])))
    return [1 + i for i in ids]  # 0 is blank


def make_synthetic_dataset(
    num_utts: int = 128,
    num_phones: int = 16,
    min_len: int = 3,
    max_len: int = 10,
    seed: int = 0,
    zipf: bool = True,
    syntax: str = "iid",  # iid | markov
    style: str = "tone",  # tone | formant
) -> tuple[list, Vocab]:
    """Random phone strings -> synthetic audio.

    syntax="iid": Zipf-ish independent draws (non-trivial unigram stats).
    syntax="markov": strings from `synthetic_phonotactics` — required for
    unsupervised identifiability (see that docstring).
    style="tone": one pure tone per phone (the easy corpus — CPC can
    track deterministic phase). style="formant": narrowband-noise
    formant synthesis with speaker/channel variation
    (`synth_formant_audio`) — the hard quality stand-in."""
    rng = np.random.RandomState(seed)
    vocab = make_vocab([f"p{i}" for i in range(num_phones)])
    trans = synthetic_phonotactics(num_phones) if syntax == "markov" else None
    # ids 1..num_phones are real phones (0 = blank)
    weights = 1.0 / np.arange(1, num_phones + 1) if zipf else np.ones(num_phones)
    weights = weights / weights.sum()
    examples = []
    for _ in range(num_utts):
        n = rng.randint(min_len, max_len + 1)
        if trans is not None:
            ids = sample_phone_string(n, trans, rng)
        else:
            ids = list(1 + rng.choice(num_phones, size=n, p=weights))
            # avoid immediate repeats (CTC cannot emit them without
            # blanks, and real phone strings rarely repeat)
            ids = [int(ids[0])] + [
                int(x) if x != ids[i] else int(1 + (x % num_phones))
                for i, x in enumerate(ids[1:])
            ]
        if style == "formant":
            synth = lambda ids, **kw: synth_formant_audio(  # noqa: E731
                ids, num_phones, **kw)
        elif style == "tone":
            synth = synth_tone_audio
        else:
            raise ValueError(f"unknown synthetic style {style!r}")
        examples.append((synth(ids, rng=rng), ids))
    return examples, vocab


# -------------------------------------------------------------- batching


def _bucket_length(n: int, boundaries: Sequence[int]) -> int:
    for b in boundaries:
        if n <= b:
            return b
    return boundaries[-1]


def batch_iterator(
    examples: Sequence[tuple[np.ndarray, list[int]]],
    batch_size: int,
    max_audio_samples: int,
    max_label_len: int,
    seed: int = 0,
    shuffle: bool = True,
    drop_remainder: bool = True,
    num_epochs: int | None = None,
    bucket_boundaries: Sequence[int] = (),
) -> Iterator[Batch]:
    """Shuffle -> bucket by audio length -> pad -> yield Batch.

    Static shapes: audio padded to the bucket boundary (or the global
    max), labels to max_label_len. Over-long examples are clipped.
    """
    if not bucket_boundaries:
        bucket_boundaries = (max_audio_samples,)
    bucket_boundaries = sorted(int(b) for b in bucket_boundaries)
    rng = np.random.RandomState(seed)
    epoch = 0
    while num_epochs is None or epoch < num_epochs:
        order = np.arange(len(examples))
        if shuffle:
            rng.shuffle(order)
        buckets: dict[int, list[int]] = {b: [] for b in bucket_boundaries}
        for i in order:
            audio, ids = examples[i]
            L = min(len(audio), max_audio_samples)
            b = _bucket_length(L, bucket_boundaries)
            buckets[b].append(i)
            if len(buckets[b]) == batch_size:
                yield _make_batch(
                    [examples[j] for j in buckets[b]], b, max_label_len
                )
                buckets[b] = []
        if not drop_remainder:
            for b, idxs in buckets.items():
                if idxs:
                    yield _make_batch(
                        [examples[j] for j in idxs], b, max_label_len
                    )
        epoch += 1


def _make_batch(exs, audio_len: int, max_label_len: int) -> Batch:
    B = len(exs)
    # examples may hold raw audio [L] or precomputed features [T, D]
    # (self-training over an SSL feature cache); pad either along axis 0
    feat_dims = np.shape(exs[0][0])[1:]
    audio = np.zeros((B, audio_len, *feat_dims), np.float32)
    a_len = np.zeros((B,), np.int32)
    labels = np.zeros((B, max_label_len), np.int32)
    l_len = np.zeros((B,), np.int32)
    for i, (a, ids) in enumerate(exs):
        n = min(len(a), audio_len)
        audio[i, :n] = a[:n]
        a_len[i] = n
        u = min(len(ids), max_label_len)
        labels[i, :u] = ids[:u]
        l_len[i] = u
    return Batch(audio, a_len, labels, l_len)


def text_batch_iterator(sequences: Sequence[Sequence[int]], batch_size: int, max_len: int,
                        seed: int = 0, num_epochs: int | None = None) -> Iterator[TextBatch]:
    """Shuffled full batches of text, padded (and clipped) to ``max_len``;
    the last partial batch of each epoch is dropped."""
    rng = np.random.RandomState(seed)
    epoch = 0
    while num_epochs is None or epoch < num_epochs:
        order = np.arange(len(sequences))
        rng.shuffle(order)
        for s in range(0, len(order) - batch_size + 1, batch_size):
            idxs = order[s : s + batch_size]
            ids = np.zeros((batch_size, max_len), np.int32)
            lens = np.zeros((batch_size,), np.int32)
            for j, i in enumerate(idxs):
                seq = list(sequences[i])[:max_len]
                ids[j, : len(seq)] = seq
                lens[j] = len(seq)
            yield TextBatch(ids, lens)
        epoch += 1


def prefetch(it: Iterator, depth: int = 2) -> Iterator:
    """Background-thread prefetch (the reference used tf.data prefetch).

    Worker exceptions (bad wav, rate mismatch, ...) are re-raised in the
    consumer — the stream must fail loudly, not end early and
    'successfully'. An abandoned consumer (islice cap, early loop exit,
    generator GC) stops the worker: the put loop polls a stop flag that
    the wrapper's GeneratorExit sets, so no thread stays blocked holding
    decoded batches."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    _END = object()
    _ERR = object()
    stop = threading.Event()

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in it:
                if not _put(item):
                    return
        except BaseException as e:  # re-raised in the consumer
            _put((_ERR, e))
        else:
            _put(_END)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                return
            if isinstance(item, tuple) and len(item) == 2 and item[0] is _ERR:
                raise item[1]
            yield item
    finally:
        stop.set()
