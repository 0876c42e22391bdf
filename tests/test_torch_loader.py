"""The port's data-at-scale layer against the JAX package's, on the same
files: the native host runtime (parallel PCM16 decode, batched edit
distance), the streaming loader and its length sidecar, and the
``prepare`` subcommands that write lists, sidecars, vocabularies, CMVN
statistics and the synthetic corpus."""

import pathlib
import struct
import time
import wave

import numpy as np
import pytest
import torch

from uasr import native as jax_native
from uasr.data import loader as jax_loader
from uasr.tools import prepare as jax_prepare
from uasr.vocab import load_vocab as jax_load_vocab
from uasr_torch import native
from uasr_torch.data import loader
from uasr_torch.data.dataset import make_synthetic_dataset, prefetch
from uasr_torch.data.io import read_wav, write_wav
from uasr_torch.ops.edit_distance import batch_edit_distance
from uasr_torch.tools import prepare
from uasr_torch.vocab import load_vocab

CONFIGS = pathlib.Path(__file__).resolve().parents[1] / "configs"


@pytest.fixture(scope="module")
def jax_lib():
    """The JAX package's C++ library: without it its binding silently
    falls back to Python, which is not the reference these tests want."""
    if jax_native.load() is None:
        pytest.skip("the JAX package's native library does not build here")


def _write_pcm(path, frames: np.ndarray, rate=16000, width=2):
    """frames [n, channels] int16 (or raw bytes per sample for width != 2)."""
    with wave.open(str(path), "wb") as w:
        w.setnchannels(frames.shape[1])
        w.setsampwidth(width)
        w.setframerate(rate)
        w.writeframes(frames.astype("<i2").tobytes() if width == 2 else
                      frames.astype(np.uint8).tobytes())


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """32 mono utterances of 0.4-1.9 s as a list with transcripts, their
    vocab, and 4 stereo files."""
    root = tmp_path_factory.mktemp("corpus")
    examples, vocab = make_synthetic_dataset(num_utts=32, num_phones=6, seed=7,
                                             min_len=4, max_len=12)
    lines = []
    for i, (audio, ids) in enumerate(examples):
        path = root / f"utt{i:04d}.wav"
        write_wav(str(path), audio, 16000)
        lines.append(f"utt{i:04d}\t{path}\t{' '.join(vocab.tokens[j] for j in ids)}")
    (root / "train.tsv").write_text("\n".join(lines) + "\n")
    (root / "vocab.txt").write_text("\n".join(vocab.tokens) + "\n")
    rng = np.random.RandomState(3)
    stereo = []
    for i, ch in enumerate((2, 2, 3, 2)):
        path = root / f"stereo{i}.wav"
        _write_pcm(path, rng.randint(-32768, 32768, (rng.randint(500, 3000), ch)))
        stereo.append(str(path))
    return root, load_vocab(str(root / "vocab.txt")), stereo


def _wavs(root):
    return sorted(str(p) for p in root.glob("utt*.wav"))


# ------------------------------------------------------------ native runtime


@pytest.mark.parametrize("kind", ["mono", "stereo"])
@pytest.mark.parametrize("threads", [0, 3])
def test_native_reader_matches_jax_cpp_and_read_wav(corpus, jax_lib, kind, threads):
    root, _, stereo = corpus
    paths = _wavs(root)[:12] if kind == "mono" else stereo
    longest = max(len(read_wav(p)[0]) for p in paths)
    for max_samples in (longest, longest // 2):  # and truncated to half the longest
        got = native.batch_read_wavs_native(paths, max_samples, num_threads=threads)
        want = jax_native.batch_read_wavs_native(paths, max_samples, num_threads=threads)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
        audio, lengths, rates = got
        assert (rates == 16000).all()
        for b, p in enumerate(paths):
            plain = read_wav(p)[0][:max_samples]
            assert lengths[b] == len(plain)
            assert not audio[b, len(plain):].any()
            if kind == "mono":
                np.testing.assert_array_equal(audio[b, : len(plain)], plain)
            else:  # (sum / ch) * scale against the mean of the scaled values
                np.testing.assert_array_max_ulp(audio[b, : len(plain)], plain, maxulp=1)


@pytest.mark.parametrize("bad", ["missing", "truncated", "pcm8", "not_riff", "no_data"])
def test_native_reader_marks_undecodable_files(corpus, jax_lib, tmp_path, bad):
    root, _, _ = corpus
    good = _wavs(root)[0]
    path = tmp_path / f"{bad}.wav"
    if bad == "truncated":
        path.write_bytes(pathlib.Path(good).read_bytes()[:-100])
    elif bad == "pcm8":
        _write_pcm(path, np.full((400, 1), 128), width=1)
    elif bad == "not_riff":
        path.write_bytes(b"OggS" + bytes(200))
    elif bad == "no_data":
        blob = pathlib.Path(good).read_bytes()
        path.write_bytes(blob[:36])  # RIFF header and fmt chunk only
    paths = [good, str(path), good]
    got = native.batch_read_wavs_native(paths, 40000)
    want = jax_native.batch_read_wavs_native(paths, 40000)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert list(got[1] < 0) == [False, True, False]
    assert not got[0][1].any()


def test_native_edit_distance_matches_jax_and_torch(jax_lib):
    rng = np.random.RandomState(0)
    B, N, M = 24, 20, 26
    refs = rng.randint(1, 7, (B, N)).astype(np.int32)
    hyps = rng.randint(1, 7, (B, M)).astype(np.int32)
    ref_lens = rng.randint(0, N + 1, B).astype(np.int32)
    hyp_lens = rng.randint(0, M + 1, B).astype(np.int32)
    got = native.batch_edit_distance_native(refs, ref_lens, hyps, hyp_lens, num_threads=4)
    np.testing.assert_array_equal(
        got, jax_native.batch_edit_distance_native(refs, ref_lens, hyps, hyp_lens))
    plain = batch_edit_distance(*(torch.as_tensor(x, dtype=torch.long)
                                  for x in (refs, ref_lens, hyps, hyp_lens)))
    np.testing.assert_array_equal(got, plain.numpy())
    with pytest.raises(ValueError, match="outside"):
        native.batch_edit_distance_native(refs, ref_lens + N, hyps, hyp_lens)


def test_failed_native_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    from uasr_torch import _build

    (tmp_path / "broken.cpp").write_text("int f( {\n")
    monkeypatch.setattr(_build, "NATIVE", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError,
                       match=r"native host runtime build failed:(.|\n)*broken\.cpp(.|\n)*error"):
        _build.load_host("broken")
    assert not list((tmp_path / "build").glob("*.so"))


# ----------------------------------------------------- lengths and sidecars


def test_scan_lengths_and_sidecar_round_trip(corpus, monkeypatch):
    root, vocab, _ = corpus
    lst = str(root / "train.tsv")
    paths = _wavs(root)
    for g, w in zip(loader.scan_lengths(paths, 4), jax_loader.scan_lengths(paths, 4)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert loader.wav_header_info(paths[0]) == jax_loader.wav_header_info(paths[0])
    assert loader.read_length_sidecar(lst + ".lens") is None
    side = pathlib.Path(loader.write_length_sidecar(lst))
    blob = side.read_bytes()
    assert pathlib.Path(jax_loader.write_length_sidecar(lst)).read_bytes() == blob
    table = loader.read_length_sidecar(str(side))
    assert table == jax_loader.read_length_sidecar(str(side)) and len(table) == 32
    scanned = loader.StreamingASRDataset.from_file(lst, vocab, scanned=loader.scan_lengths(paths))

    def no_open(*a, **k):
        raise AssertionError("wave.open called despite the .lens sidecar")

    with monkeypatch.context() as m:  # the sidecar replaces the header scan
        m.setattr(wave, "open", no_open)
        ds = loader.StreamingASRDataset.from_file(lst, vocab)
    np.testing.assert_array_equal(ds.num_samples, scanned.num_samples)
    try:
        side.write_bytes(b"".join(blob.splitlines(keepends=True)[1:]))  # one utterance short
        with monkeypatch.context() as m:
            calls = []
            m.setattr(loader, "scan_lengths", lambda p, t=16: calls.append(p) or
                      jax_loader.scan_lengths(p, t))
            ds = loader.StreamingASRDataset.from_file(lst, vocab)
        assert len(calls) == 1 and len(calls[0]) == 32  # a full rescan
        np.testing.assert_array_equal(ds.num_samples, scanned.num_samples)
        side.write_text("utt0000\t123\n")
        for mod in (loader, jax_loader):
            with pytest.raises(ValueError, match="malformed length-cache line"):
                mod.read_length_sidecar(str(side))
        with pytest.raises(ValueError, match="malformed"):
            loader.StreamingASRDataset.from_file(lst, vocab)
    finally:
        side.unlink()


# ------------------------------------------------------------ the stream


STREAM_CASES = {
    "full_shuffle": dict(batch_size=4, max_audio_samples=24000, max_label_len=12, seed=3,
                         num_epochs=1),
    "window_shuffle": dict(batch_size=4, max_audio_samples=24000, max_label_len=12, seed=5,
                           shuffle_buffer=7, num_epochs=1, bucket_boundaries=(16000, 24000)),
    "keep_remainder": dict(batch_size=5, max_audio_samples=20000, max_label_len=8, seed=1,
                           num_epochs=1, drop_remainder=False,
                           bucket_boundaries=(8000, 16000, 20000), decode_threads=2),
    "two_epochs_bounds": dict(batch_size=3, max_audio_samples=24000, max_label_len=10, seed=9,
                              num_epochs=2, bucket_boundaries=(12000, 18000, 24000)),
    "no_shuffle": dict(batch_size=6, max_audio_samples=16000, max_label_len=12, shuffle=False,
                       num_epochs=1, drop_remainder=False),
}


@pytest.mark.parametrize("case", list(STREAM_CASES))
def test_stream_batches_match_jax(corpus, jax_lib, case):
    root, vocab, _ = corpus
    lst = str(root / "train.tsv")
    kw = STREAM_CASES[case]
    got = list(loader.StreamingASRDataset.from_file(lst, vocab).batches(**kw))
    ds = jax_loader.StreamingASRDataset.from_file(lst, jax_load_vocab(str(root / "vocab.txt")))
    want = list(ds.batches(**kw))
    assert len(got) == len(want) > 3
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_prefetched_stream_runs_at_most_four_batches_ahead(corpus):
    """Under ``prefetch(depth=2)`` the loader decodes one batch at a time:
    two queued, one held by a blocked put, one being built."""
    root, vocab, _ = corpus
    ds = loader.StreamingASRDataset.from_file(str(root / "train.tsv"), vocab)
    decoded = []
    it = prefetch(ds.batches(batch_size=4, max_audio_samples=24000, max_label_len=12,
                             num_epochs=2, on_decode=decoded.append), depth=2)
    consumed = 0
    for _ in it:
        consumed += 1
        time.sleep(0.005)  # let the worker run ahead if it could
        assert len(decoded) - consumed <= 4
    assert consumed == len(decoded) >= 10


@pytest.mark.parametrize("fault", ["decode", "rate_at_scan", "rate_at_decode"])
def test_stream_raises_where_jax_raises(corpus, jax_lib, tmp_path, fault):
    root, vocab, _ = corpus
    jvocab = jax_load_vocab(str(root / "vocab.txt"))
    good = _wavs(root)
    lst = tmp_path / "list.tsv"
    rows = [f"u{i}\t{p}\tp1 p2" for i, p in enumerate(good[:6])]
    if fault == "rate_at_scan":
        write_wav(str(tmp_path / "8k.wav"), np.zeros(800, np.float32), 8000)
        rows[2] = f"u2\t{tmp_path / '8k.wav'}\tp1"
    lst.write_text("\n".join(rows) + "\n")
    kw = dict(batch_size=2, max_audio_samples=24000, max_label_len=4, num_epochs=1,
              shuffle=False)
    errors = []
    for mod, voc in ((loader, vocab), (jax_loader, jvocab)):
        with pytest.raises(ValueError) as e:
            ds = mod.StreamingASRDataset.from_file(str(lst), voc)
            if fault == "decode":  # the file goes after the header scan
                ds.utts[3].wav_path = str(tmp_path / "missing.wav")
            elif fault == "rate_at_decode":  # the scan said 16 kHz, the file is 8 kHz
                write_wav(str(tmp_path / "8k.wav"), np.zeros(800, np.float32), 8000)
                ds.utts[1].wav_path = str(tmp_path / "8k.wav")
            list(ds.batches(**kw))
        errors.append(str(e.value))
    assert errors[0] == errors[1]


# ------------------------------------------------------------ prepare


def _run_both(args_port, args_jax):
    assert prepare.main(args_port) == 0
    assert jax_prepare.main(args_jax) == 0


def test_prepare_lists_scan_lengths_vocab_match_jax(corpus, tmp_path):
    root, _, _ = corpus
    wavs = _wavs(root)
    (tmp_path / "wav.scp").write_text(
        "".join(f"utt{i:04d} {p}\n" for i, p in reversed(list(enumerate(wavs)))))
    (tmp_path / "text").write_text(
        "".join(f"utt{i:04d} {'a b' if i % 3 else 'c'}\n" for i in range(0, len(wavs), 2)))
    (tmp_path / "phones.txt").write_text("a b a\nc b\n\nq a a\n")
    out = {}
    for tag in ("port", "jax"):
        d = tmp_path / tag
        d.mkdir()
        cmds = [["lists", "--wav-scp", str(tmp_path / "wav.scp"), "--text",
                 str(tmp_path / "text"), "--out", str(d / "train.tsv")],
                ["lists", "--wav-scp", str(tmp_path / "wav.scp"), "--out",
                 str(d / "bare.tsv"), "--no-lens"],
                ["scan-lengths", "--list", str(d / "bare.tsv"), "--threads", "3"],
                ["vocab", "--text", str(tmp_path / "phones.txt"), "--out", str(d / "v.txt")],
                ["vocab", "--text", str(tmp_path / "text"), "--has-utt-ids",
                 "--out", str(d / "v_ids.txt")]]
        for cmd in cmds:
            assert (prepare if tag == "port" else jax_prepare).main(cmd) == 0
        out[tag] = {p.name: p.read_bytes() for p in sorted(d.iterdir())}
    assert sorted(out["port"]) == ["bare.tsv", "bare.tsv.lens", "train.tsv", "train.tsv.lens",
                                   "v.txt", "v_ids.txt"]
    assert out["port"] == out["jax"]


def test_prepare_synth_matches_jax(tmp_path):
    args = ["--num-utts", "24", "--num-phones", "6", "--seed", "4", "--syntax", "markov",
            "--max-len", "8"]
    _run_both(["synth", "--out-dir", str(tmp_path / "port"), *args],
              ["synth", "--out-dir", str(tmp_path / "jax"), *args])
    files = {}
    for tag in ("port", "jax"):
        base = tmp_path / tag
        files[tag] = {str(p.relative_to(base)): p.read_bytes().replace(str(base).encode(), b"D")
                      for p in sorted(base.rglob("*")) if p.is_file()}
    assert len(files["port"]) == 24 + 6
    assert files["port"] == files["jax"]
    # --align: the fourth column of per-frame phone labels, the same bytes
    _run_both(["synth", "--out-dir", str(tmp_path / "port_al"), "--align", *args],
              ["synth", "--out-dir", str(tmp_path / "jax_al"), "--align", *args])
    for tag in ("port_al", "jax_al"):
        base = tmp_path / tag
        files[tag] = {str(p.relative_to(base)): p.read_bytes().replace(str(base).encode(), b"D")
                      for p in sorted(base.rglob("*")) if p.is_file()}
    assert files["port_al"] == files["jax_al"]
    assert files["port_al"]["train.tsv"] != files["port"]["train.tsv"]
    assert all(ln.count(b"\t") == 3 for ln in files["port_al"]["train.tsv"].splitlines())


@pytest.mark.parametrize("recipe", ["synthetic_smoke", "timit_ctc_mini"])
def test_prepare_cmvn_matches_jax(corpus, tmp_path, recipe):
    root, _, _ = corpus
    args = ["--list", str(root / "train.tsv"), "--vocab", str(root / "vocab.txt"),
            "--config", str(CONFIGS / f"{recipe}.yaml")]
    _run_both(["cmvn", *args, "--out", str(tmp_path / "port.npz")],
              ["cmvn", *args, "--out", str(tmp_path / "jax.npz")])
    got, want = np.load(tmp_path / "port.npz"), np.load(tmp_path / "jax.npz")
    assert sorted(got.files) == sorted(want.files) == ["mean", "std"]
    for k in ("mean", "std"):
        assert got[k].dtype == want[k].dtype == np.float32
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6)
    assert got["mean"].shape == ((120,) if recipe == "timit_ctc_mini" else (40,))


def test_wav_header_info_rejects_garbage(tmp_path):
    p = tmp_path / "x.wav"
    p.write_bytes(b"RIFF" + struct.pack("<I", 4) + b"WAVE")
    with pytest.raises(ValueError, match="unreadable wav header"):
        loader.wav_header_info(str(p))
