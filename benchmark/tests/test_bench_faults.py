"""A run of each small cell with the program broken underneath comes out
not correct, once for each fault the cell can have; the sound run comes
out correct. The harness's look for a card is skipped (``run_cell`` on
the CPU); the rest of the run is the benchmark's own."""

from __future__ import annotations

import pytest

from benchmark.tests import tiny

UNCHANGED_STEP = """
from uasr_torch import train as T
def step(self, state, batch, generator=None):
    aux, grads = self.loss_and_grads(state.params, batch,
                                     generator or self.step_generator(state.step))
    aux["grad_norm"] = self.optimizer.norm(grads)
    return T.TrainState(state.step + 1, state.params, state.opt_state), aux
T.CTCTrainer.train_step = step
"""
HALF_BATCH_MEAN = """
from uasr_torch.parallel import collectives as C
C.batch_mean = lambda per_row: per_row[: per_row.shape[0] // 2].mean()
"""
DECODE_HALF = """
from uasr_torch import infer
_orig = infer._decode_batch
def half(*a, **k):
    hyps, hyp_len, e, t = _orig(*a, **k)
    hyp_len = hyp_len.clone()
    hyp_len[hyp_len.shape[0] // 2:] = 0
    return hyps, hyp_len, e, t
infer._decode_batch = half
"""
DECODE_TOKEN = """
from uasr_torch import infer
_orig = infer._decode_batch
def altered(*a, **k):
    hyps, hyp_len, e, t = _orig(*a, **k)
    hyps = hyps.clone()
    hyps[:, 0] = hyps[:, 0] % 27 + 1 + (hyps[:, 0] % 27 + 1 == hyps[:, 0]).long()
    return hyps, hyp_len, e, t
infer._decode_batch = altered
"""
STREAM_UNCHANGED = """
from uasr_torch import serve as S
_orig = S.StreamingRecognizer._step_impl
def stale(self, state, chunk):
    _new, ids, counts = _orig(self, state, chunk)
    return state, ids, counts
S.StreamingRecognizer._step_impl = stale
"""
STREAM_HALF = """
import torch
from uasr_torch import serve as S
_orig = S.StreamingRecognizer._masked_step
def half(self, state, chunks, mask, smask, frames):
    keep = torch.arange(mask.shape[0], device=mask.device) < mask.shape[0] // 2
    return _orig(self, state, chunks, mask & keep, smask, frames)
S.StreamingRecognizer._masked_step = half
"""
STREAM_TOKEN = """
from uasr_torch import serve as S
_orig = S.StreamingRecognizer._finish_and_reset
def altered(self, state, mask):
    kept, out = _orig(self, state, mask)
    out = out.clone()
    out[:, 0] = (out[:, 0] + 1) % 48 + 1
    return kept, out
S.StreamingRecognizer._finish_and_reset = altered
"""

CASES = [
    ("tiny_libri.train_bucketed", "sound", ""),
    ("tiny_libri.train_bucketed", "state left unchanged", UNCHANGED_STEP),
    ("tiny_libri.train_bucketed", "half the batch, mean over the rest", HALF_BATCH_MEAN),
    ("tiny_libri.decode_64", "sound", ""),
    ("tiny_libri.decode_64", "half the batch left out", DECODE_HALF),
    ("tiny_libri.decode_64", "a token altered", DECODE_TOKEN),
    ("tiny_ais.stream_256", "sound", ""),
    ("tiny_ais.stream_256", "state left unchanged", STREAM_UNCHANGED),
    ("tiny_ais.stream_256", "half the slots left out", STREAM_HALF),
    ("tiny_ais.stream_256", "a token altered", STREAM_TOKEN),
]


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    return tiny.make_copy(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell,fault,patch", CASES, ids=[f"{c}-{f}" for c, f, _ in CASES])
def test_fault_makes_the_run_not_correct(copy, cell, fault, patch):
    out = tiny.result(tiny.run(copy, tiny.rehearse(cell, patch=patch)))
    assert out["correct"] == (fault == "sound"), out["checks"]
