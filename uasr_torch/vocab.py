"""Vocabulary handling (copy of ``uasr.vocab``): phone/char token tables,
special symbols, and the TIMIT 61->39 phone fold used at scoring time.

Reference behavior (SURVEY.md L1 / §2.2 "Decode & metrics"): vocab file is
one token per line; special tokens <blk>/<unk>/<pad> participate; decode maps
ids back to phones and TIMIT recipes fold 61 phones to 39 before computing
PER. Here the blank id is explicit and configurable (the reference relied on
tf.nn.ctc_loss's blank-index convention).
"""

from __future__ import annotations

from dataclasses import dataclass, field

BLK = "<blk>"
UNK = "<unk>"
PAD = "<pad>"

# Standard Kaldi/TIMIT 61 -> 39 phone fold (Lee & Hon 1989). Phones that map
# to themselves are omitted; 'q' is deleted before scoring.
TIMIT_61_TO_39 = {
    "ao": "aa", "ax": "ah", "ax-h": "ah", "axr": "er", "hv": "hh",
    "ix": "ih", "el": "l", "em": "m", "en": "n", "nx": "n",
    "eng": "ng", "zh": "sh", "ux": "uw",
    "pcl": "sil", "tcl": "sil", "kcl": "sil", "bcl": "sil", "dcl": "sil",
    "gcl": "sil", "h#": "sil", "pau": "sil", "epi": "sil",
    "q": "",  # deleted
}


@dataclass
class Vocab:
    """id <-> token mapping with an explicit blank id.

    By convention blank is id 0 (matching optax.ctc_loss's default and our
    CTC kernels); vocab files that already contain <blk> keep their order.
    """

    tokens: list[str] = field(default_factory=list)
    blank_id: int = 0
    unk_id: int | None = None
    _tok2id: dict = field(default_factory=dict, repr=False)

    def __post_init__(self):
        self._tok2id = {t: i for i, t in enumerate(self.tokens)}
        if UNK in self._tok2id and self.unk_id is None:
            self.unk_id = self._tok2id[UNK]

    def __len__(self) -> int:
        return len(self.tokens)

    def encode(self, toks: list[str]) -> list[int]:
        if self.unk_id is not None:
            return [self._tok2id.get(t, self.unk_id) for t in toks]
        return [self._tok2id[t] for t in toks]

    def decode(self, ids) -> list[str]:
        return [self.tokens[int(i)] for i in ids]

    def decode_for_scoring(self, ids, fold_timit: bool = False) -> list[str]:
        """ids -> tokens, dropping blank/pad; optional TIMIT 61->39 fold
        (reference: `int2phone` + fold before PER, SURVEY.md §3.4)."""
        out = []
        for i in ids:
            i = int(i)
            if i == self.blank_id:
                continue
            t = self.tokens[i]
            if t in (BLK, PAD):
                continue
            if fold_timit:
                t = TIMIT_61_TO_39.get(t, t)
                if t == "":
                    continue
            out.append(t)
        return out


def load_vocab(path: str, add_blank: bool = True) -> Vocab:
    """Load one-token-per-line vocab. If the file has no <blk>, one is
    prepended at id 0 (our CTC blank convention)."""
    with open(path) as f:
        tokens = [ln.strip() for ln in f if ln.strip()]
    if add_blank and BLK not in tokens:
        tokens = [BLK] + tokens
    blank_id = tokens.index(BLK) if BLK in tokens else 0
    return Vocab(tokens=tokens, blank_id=blank_id)


def make_vocab(tokens: list[str]) -> Vocab:
    """Build a vocab from raw (non-special) tokens, blank at id 0."""
    toks = [BLK] + [t for t in tokens if t not in (BLK,)]
    if UNK not in toks:
        toks.append(UNK)
    return Vocab(tokens=toks, blank_id=0)
