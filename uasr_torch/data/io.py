"""Minimal audio / list-file IO, host side (copy of ``uasr.data.io``).

The reference read Kaldi-style wav.scp / csv utterance lists and raw
PCM wavs (SURVEY.md §2.2 "Dataset classes"). Supported list format, one
utterance per line, tab- or comma-separated:

    utt_id <sep> wav_path <sep> transcript tokens ...

Lines with two fields are unlabeled (GAN/EODM audio side).
"""

from __future__ import annotations

import os
import wave
from dataclasses import dataclass

import numpy as np


@dataclass
class Utterance:
    utt_id: str
    wav_path: str
    tokens: list[str]
    # optional per-frame phone labels (forced alignment), the reference's
    # ASR_align_DataSet variant (SURVEY.md §2.2): 4th list column holds
    # space-separated frame tokens
    align_tokens: list[str] | None = None


def read_utterance_list(path: str) -> list[Utterance]:
    utts = []
    with open(path) as f:
        for ln in f:
            ln = ln.strip()
            if not ln or ln.startswith("#"):
                continue
            sep = "\t" if "\t" in ln else ","
            parts = [p.strip() for p in ln.split(sep)]
            toks = parts[2].split() if len(parts) > 2 and parts[2] else []
            align = (
                parts[3].split() if len(parts) > 3 and parts[3] else None
            )
            utts.append(Utterance(parts[0], parts[1], toks, align))
    return utts


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """PCM16 mono wav -> (float32 in [-1, 1], sample_rate)."""
    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        n = w.getnframes()
        raw = w.readframes(n)
        width = w.getsampwidth()
        ch = w.getnchannels()
    if width != 2:
        raise ValueError(f"{path}: only PCM16 supported, got width={width}")
    audio = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    if ch > 1:
        audio = audio.reshape(-1, ch).mean(axis=1)
    return audio, sr


def write_wav(path: str, audio: np.ndarray, sample_rate: int) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    pcm = np.clip(audio * 32767.0, -32768, 32767).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())
