"""Kaldi-format table IO (ark / scp), numpy only: a copy of
``uasr.data.kaldi``, whose ``_seek_key`` also skips alignment records
(``skip``, int vectors by default; feature tables pass ``read_matrix``).

Users switching from Kaldi hold ``feats.scp`` + ``.ark`` float-matrix
tables (often compressed) and ``ali.ark`` int32 alignment vectors. This
module reads those tables (binary ``FM`` / ``DM``, compressed ``CM`` /
``CM2`` / ``CM3``, text-mode matrices and binary integer vectors) and
writes uncompressed binary ``FM`` arks + scp, so feature caches go back
into Kaldi pipelines (``prepare import-features`` / ``export-kaldi`` /
``import-ali``). No Kaldi installation is needed.

Byte layout, from the published Kaldi serialization
(kaldi/src/matrix/kaldi-matrix.cc, compressed-matrix.cc, base/io-funcs.h):

  record      := utt_key ' ' object
  object      := '\\0B' binary_obj | text_obj
  binary mat  := token ' ' dims payload        (token: FM|DM|CM|CM2|CM3)
  dims (FM/DM):= '\\x04' int32 rows '\\x04' int32 cols
  FM payload  := rows*cols float32 LE, row-major  (DM: float64)
  CM* payload := global header (float min, float range, int32 rows,
                 int32 cols); CM adds per-column uint16 percentile
                 quadruples + uint8 data column-major; CM2 = uint16
                 row-major; CM3 = uint8 row-major
  int vector  := '\\x04' int32 size  size*int32 LE  (no token)
  scp line    := utt_key ' ' ark_path ':' byte_offset_of_the_object
"""

from __future__ import annotations

import os
import struct
from typing import Iterable, Iterator, Sequence

import numpy as np

_BINARY_MARKER = b"\x00B"


# ---------------------------------------------------------------------------
# scp parsing


def read_scp(path: str) -> list[tuple[str, str, int]]:
    """Parse an scp file into (utt_id, ark_path, byte_offset) triples.

    Kaldi scp lines look like ``utt path/to/file.ark:12345``; the offset
    points at the object (the binary marker), just past the key+space
    the writer emitted.  Lines without ``:offset`` get offset -1 and are
    resolved by scanning keys sequentially.  Relative ark paths are
    tried as written first, then relative to the scp's directory.
    """
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
                raise ValueError(f"malformed scp line in {path!r}: {raw!r}")
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


# ---------------------------------------------------------------------------
# low-level binary readers


def _read_exact(f, n: int) -> bytes:
    b = f.read(n)
    if len(b) != n:
        raise EOFError(f"unexpected EOF in kaldi table (wanted {n} bytes)")
    return b


def _read_int32(f) -> int:
    size = _read_exact(f, 1)
    if size != b"\x04":
        raise ValueError(
            f"expected int32 size marker \\x04, got {size!r} — "
            "not a kaldi binary int (wrong offset or corrupt ark?)"
        )
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


def _uint16_to_float(u: np.ndarray, mn: float, rng: float) -> np.ndarray:
    return (mn + rng * (1.0 / 65535.0) * u.astype(np.float32)).astype(
        np.float32
    )


def _decode_cm1(f, mn, rng, rows, cols) -> np.ndarray:
    """Format 1: per-column uint16 percentile headers + uint8 data
    (column-major), piecewise-linear dequantization."""
    hdr = np.frombuffer(_read_exact(f, 8 * cols), dtype="<u2").reshape(
        cols, 4
    )
    p = _uint16_to_float(hdr, mn, rng)  # [cols, 4]: p0 p25 p75 p100
    data = np.frombuffer(_read_exact(f, rows * cols), dtype=np.uint8)
    c = data.reshape(cols, rows).astype(np.float32)  # column-major on disk
    p0, p25, p75, p100 = (p[:, i : i + 1] for i in range(4))
    lo = p0 + (p25 - p0) * (c * (1.0 / 64.0))
    mid = p25 + (p75 - p25) * ((c - 64.0) * (1.0 / 128.0))
    hi = p75 + (p100 - p75) * ((c - 192.0) * (1.0 / 63.0))
    vals = np.where(c <= 64.0, lo, np.where(c <= 192.0, mid, hi))
    return vals.T.astype(np.float32)


def read_matrix(f) -> np.ndarray:
    """Read one matrix object at the current position (binary or text)."""
    marker = f.read(2)
    if marker != _BINARY_MARKER:
        return _read_text_matrix(f, marker)
    tok = _read_token(f)
    if tok in ("FM", "DM"):
        rows, cols = _read_int32(f), _read_int32(f)
        dt = "<f4" if tok == "FM" else "<f8"
        n = rows * cols * (4 if tok == "FM" else 8)
        mat = np.frombuffer(_read_exact(f, n), dtype=dt).reshape(rows, cols)
        return mat.astype(np.float32)
    if tok in ("CM", "CM2", "CM3"):
        mn, rng = struct.unpack("<ff", _read_exact(f, 8))
        rows, cols = struct.unpack("<ii", _read_exact(f, 8))
        if tok == "CM":
            return _decode_cm1(f, mn, rng, rows, cols)
        if tok == "CM2":
            u = np.frombuffer(_read_exact(f, 2 * rows * cols), dtype="<u2")
            return _uint16_to_float(u, mn, rng).reshape(rows, cols)
        u = np.frombuffer(_read_exact(f, rows * cols), dtype=np.uint8)
        vals = mn + rng * (1.0 / 255.0) * u.astype(np.float32)
        return vals.reshape(rows, cols).astype(np.float32)
    raise ValueError(f"unsupported kaldi matrix token {tok!r}")


def _read_text_matrix(f, prefix: bytes) -> np.ndarray:
    """Text-mode matrix: ' [\\n r0c0 r0c1\\n ... ]'. `prefix` holds the
    2 bytes already consumed by the binary-marker probe."""
    buf = bytearray(prefix)
    while b"]" not in buf:
        chunk = f.read(4096)
        if not chunk:
            raise EOFError("unterminated text matrix (no ']')")
        buf += chunk
    end = buf.index(b"]")
    f.seek(-(len(buf) - end - 1), os.SEEK_CUR)  # return unused bytes
    body = buf[:end].decode("ascii")
    if "[" not in body:
        raise ValueError("text matrix missing '['")
    body = body.split("[", 1)[1]
    rows = [r.split() for r in body.strip().splitlines() if r.strip()]
    if not rows:
        return np.zeros((0, 0), np.float32)
    return np.asarray([[float(x) for x in r] for r in rows], np.float32)


def read_int_vector(f) -> np.ndarray:
    """Read one binary int32 vector (Kaldi alignment) at the current
    position.  Token-less: '\\0B' then size then data."""
    marker = _read_exact(f, 2)
    if marker != _BINARY_MARKER:
        # text mode: whitespace-separated ints to end of line
        line = marker + f.readline()
        return np.asarray([int(x) for x in line.split()], np.int32)
    n = _read_int32(f)
    return np.frombuffer(_read_exact(f, 4 * n), dtype="<i4").copy()


# ---------------------------------------------------------------------------
# table iteration


def _read_key(f) -> str | None:
    """Read the next record key (skipping inter-record whitespace);
    None at a clean EOF."""
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
            continue  # leading whitespace between text records
        key += c


def _seek_key(f, want: str, skip=None) -> None:
    """Scan records' keys until ``want`` (an scp line without an offset),
    skipping each other record by parsing it with ``skip``: ``read_matrix``
    for feature tables, ``read_int_vector`` (the default) for alignments."""
    skip = skip or read_int_vector
    while True:
        key = _read_key(f)
        if key is None:
            raise KeyError(f"utterance {want!r} not found in ark")
        if key == want:
            return
        skip(f)


def iter_feats_scp(scp_path: str) -> Iterator[tuple[str, np.ndarray]]:
    """Yield (utt_id, feats [T, D]) for each scp entry, in scp order."""
    handles: dict[str, object] = {}
    try:
        for utt, ark, offset in read_scp(scp_path):
            f = handles.get(ark)
            if f is None:
                f = handles[ark] = open(ark, "rb")
            if offset >= 0:
                f.seek(offset)
            else:
                f.seek(0)
                _seek_key(f, utt, read_matrix)
            yield utt, read_matrix(f)
    finally:
        for f in handles.values():
            f.close()


def iter_feats_ark(ark_path: str) -> Iterator[tuple[str, np.ndarray]]:
    """Yield (utt_id, feats) sequentially from a feature ark."""
    with open(ark_path, "rb") as f:
        while True:
            key = _read_key(f)
            if key is None:
                return
            yield key, read_matrix(f)


def iter_ali(path: str) -> Iterator[tuple[str, np.ndarray]]:
    """Yield (utt_id, int32 frame labels) from an alignment ark or scp.

    Kaldi alignments hold transition-ids; convert to per-frame phone ids
    first (``ali-to-phones --per-frame``) — this reader takes the ids
    verbatim.
    """
    if path.endswith(".scp"):
        for utt, ark, offset in read_scp(path):
            with open(ark, "rb") as f:
                if offset < 0:
                    raise ValueError(
                        "alignment scp entries need explicit :offsets"
                    )
                f.seek(offset)
                yield utt, read_int_vector(f)
        return
    with open(path, "rb") as f:
        while True:
            key = _read_key(f)
            if key is None:
                return
            yield key, read_int_vector(f)


# ---------------------------------------------------------------------------
# writing


def write_feats_ark(
    out_base: str,
    examples: Iterable[tuple[str, np.ndarray]],
) -> tuple[str, str]:
    """Write (utt_id, feats [T, D]) pairs as `<out_base>.ark` (binary,
    uncompressed FM) + `<out_base>.scp`.  Returns (ark_path, scp_path)."""
    ark_path, scp_path = out_base + ".ark", out_base + ".scp"
    os.makedirs(os.path.dirname(os.path.abspath(ark_path)), exist_ok=True)
    with open(ark_path, "wb") as ark, open(scp_path, "w") as scp:
        for utt, feat in examples:
            feat = np.ascontiguousarray(feat, dtype=np.float32)
            if feat.ndim != 2:
                raise ValueError(
                    f"features for {utt!r} must be [T, D], got {feat.shape}"
                )
            ark.write(utt.encode("utf-8") + b" ")
            offset = ark.tell()
            ark.write(_BINARY_MARKER + b"FM ")
            ark.write(b"\x04" + struct.pack("<i", feat.shape[0]))
            ark.write(b"\x04" + struct.pack("<i", feat.shape[1]))
            ark.write(feat.tobytes())
            scp.write(f"{utt} {ark_path}:{offset}\n")
    return ark_path, scp_path


def write_ali_ark(
    out_base: str,
    examples: Iterable[tuple[str, Sequence[int]]],
) -> tuple[str, str]:
    """Write (utt_id, frame labels) as a binary int-vector ark + scp."""
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
