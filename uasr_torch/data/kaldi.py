"""Kaldi table IO for alignments (the part of ``uasr.data.kaldi`` that
``prepare import-ali`` reads; a copy, numpy only).

Users switching from Kaldi hold per-frame phone alignments as ark / scp
tables of binary int32 vectors (``ali-to-phones --per-frame`` output).
Byte layout, from Kaldi's serialization (base/io-funcs.h):

  record      := utt_key ' ' object
  int vector  := '\\0B' '\\x04' int32 size  size*int32 LE   (no token)
  scp line    := utt_key ' ' ark_path ':' byte_offset_of_the_object

Text-mode vectors (whitespace-separated ints to the end of the line)
are read as well. The feature-matrix tables (``FM`` / ``DM`` / ``CM*``)
come with the feature caches (ROADMAP.md Queue 1, item 10).
"""

from __future__ import annotations

import os
import struct
from typing import Iterable, Iterator, Sequence

import numpy as np

_BINARY_MARKER = b"\x00B"


def read_scp(path: str) -> list[tuple[str, str, int]]:
    """Parse an scp file into (utt_id, ark_path, byte_offset) triples.

    Kaldi scp lines look like ``utt path/to/file.ark:12345``; the offset
    points at the object (the binary marker), just past the key and space
    the writer emitted. Lines without ``:offset`` get offset -1. Relative
    ark paths are tried as written first, then relative to the scp's
    directory."""
    base = os.path.dirname(os.path.abspath(path))
    out: list[tuple[str, str, int]] = []
    with open(path) as f:
        for raw in f:
            line = raw.strip()
            if not line:
                continue
            try:
                utt, rspec = line.split(None, 1)
            except ValueError:
                raise ValueError(f"malformed scp line in {path!r}: {raw!r}") from None
            ark, _, off = rspec.rpartition(":")
            if ark and off.isdigit():
                offset = int(off)
            else:
                ark, offset = rspec, -1
            if not os.path.exists(ark):
                cand = os.path.join(base, ark)
                if os.path.exists(cand):
                    ark = cand
            out.append((utt, ark, offset))
    return out


def _read_exact(f, n: int) -> bytes:
    b = f.read(n)
    if len(b) != n:
        raise EOFError(f"unexpected EOF in kaldi table (wanted {n} bytes)")
    return b


def _read_int32(f) -> int:
    size = _read_exact(f, 1)
    if size != b"\x04":
        raise ValueError(f"expected int32 size marker \\x04, got {size!r} — not a kaldi binary "
                         "int (wrong offset or corrupt ark?)")
    return struct.unpack("<i", _read_exact(f, 4))[0]


def _read_token(f) -> str:
    tok = bytearray()
    while True:
        c = _read_exact(f, 1)
        if c == b" ":
            break
        tok += c
        if len(tok) > 8:
            raise ValueError(f"overlong kaldi token {bytes(tok)!r}")
    return tok.decode("ascii")


def read_int_vector(f) -> np.ndarray:
    """One int32 vector (a Kaldi alignment) at the current position:
    binary ('\\0B', size, data; no token) or text."""
    marker = _read_exact(f, 2)
    if marker != _BINARY_MARKER:
        line = marker + f.readline()
        return np.asarray([int(x) for x in line.split()], np.int32)
    n = _read_int32(f)
    return np.frombuffer(_read_exact(f, 4 * n), dtype="<i4").copy()


def _read_key(f) -> str | None:
    """The next record key (skipping whitespace between records); None at
    a clean EOF."""
    key = bytearray()
    while True:
        c = f.read(1)
        if not c:
            if key:
                raise EOFError("truncated ark record key")
            return None
        if c in b" \n\t\r":
            if key:
                return key.decode("utf-8")
            continue
        key += c


def _seek_key(f, want: str) -> None:
    """Scan records' keys until ``want`` (an scp line without an offset),
    skipping each other record by parsing it as an int vector."""
    while True:
        key = _read_key(f)
        if key is None:
            raise KeyError(f"utterance {want!r} not found in ark")
        if key == want:
            return
        read_int_vector(f)


def iter_ali(path: str) -> Iterator[tuple[str, np.ndarray]]:
    """(utt_id, int32 frame labels) from an alignment ark or scp.

    Kaldi alignments hold transition-ids; convert them to per-frame phone
    ids first (``ali-to-phones --per-frame``): this reader takes the ids
    as they are."""
    if path.endswith(".scp"):
        for utt, ark, offset in read_scp(path):
            with open(ark, "rb") as f:
                if offset < 0:
                    raise ValueError("alignment scp entries need explicit :offsets")
                f.seek(offset)
                yield utt, read_int_vector(f)
        return
    with open(path, "rb") as f:
        while True:
            key = _read_key(f)
            if key is None:
                return
            yield key, read_int_vector(f)


def write_ali_ark(out_base: str, examples: Iterable[tuple[str, Sequence[int]]]
                  ) -> tuple[str, str]:
    """Write (utt_id, frame labels) as a binary int-vector ark + scp
    (``<out_base>.ark``, ``<out_base>.scp``); returns their paths."""
    ark_path, scp_path = out_base + ".ark", out_base + ".scp"
    os.makedirs(os.path.dirname(os.path.abspath(ark_path)), exist_ok=True)
    with open(ark_path, "wb") as ark, open(scp_path, "w") as scp:
        for utt, ids in examples:
            v = np.ascontiguousarray(ids, dtype="<i4").reshape(-1)
            ark.write(utt.encode("utf-8") + b" ")
            offset = ark.tell()
            ark.write(_BINARY_MARKER + b"\x04" + struct.pack("<i", v.size))
            ark.write(v.tobytes())
            scp.write(f"{utt} {ark_path}:{offset}\n")
    return ark_path, scp_path
