"""The roofline and FLOP files against the bound column of PERF.md's
kernel table (its shapes, H100 SXM peaks) and a count by hand."""

from __future__ import annotations

import pytest

from benchmark.core import files

PEAKS = files.peaks()
LIBRI = files.config("librispeech_ctc_bigru")


def _ms(mod: str, *shape) -> float:
    m = files.module("roofline", mod)
    from benchmark.roofline.common import bound_s, frontend_dims

    args = list(shape)
    if mod in ("k1", "k7"):
        args.append(frontend_dims(LIBRI["recipe"]["frontend"]))
    dtype = args.pop(0)
    return 1e3 * bound_s(*m.work(*args), dtype, PEAKS)


@pytest.mark.parametrize("mod,shape,table_ms", [
    ("k1", ("float32", 32, 256000, 1598), 0.3145),
    ("k7", ("float32", 64, 240 + 64 * 160, 64), 0.0252),
    ("k2_bwd", ("bfloat16", 400, 32, 512, 8100, 2), 0.0714),
    ("k3", ("float32", 400, 32, 513, 400 * 32), 0.0157),
    ("k3_bwd", ("float32", 400, 32, 513, 400 * 32), 0.0236),
    ("k4", ("float32", 400, 32, 16, 32, 400 * 32), 0.0010),
    ("k4", ("float32", 32, 64, 8, 4233, 32 * 64), 0.0104),
])
def test_bounds_reproduce_the_kernel_table(mod, shape, table_ms):
    assert round(_ms(mod, *shape), 4) == table_ms


def test_k2_bound_spans_the_table_at_its_live_steps():
    """K2's bound counts the live row-steps, which the table's ragged
    lengths set (K2-bwd's above is bytes-bound at that count): 0.0189 ms
    lies between no live step and every row live, at about a third."""
    T, B, H = 400, 32, 512
    lo, hi = _ms("k2", "bfloat16", T, B, H, 0, 2), _ms("k2", "bfloat16", T, B, H, 2 * T * B, 2)
    assert lo < 0.0189 < hi
    frac = (0.0189 - lo) / (hi - lo)
    assert 0.25 < frac < 0.45


def test_model_flops_of_a_16_s_utterance_by_hand():
    f = files.module("flops", "conv_bigru").utterance_flops(1598, LIBRI)
    conv = 799 * 40 * 2 * 9 * 1 * 64 + 400 * 20 * 2 * 9 * 64 * 64
    gru = 400 * 2 * ((2 * 1280 * 1536 + 2 * 512 * 1536) + 2 * (2 * 1024 * 1536 + 2 * 512 * 1536))
    assert f == conv + gru + 400 * 2 * 1024 * 32
    # a training step of 32 such utterances: about 1.2 TFLOP
    assert 1.1e12 < 3 * 32 * f < 1.3e12


def test_cnn_flops_per_frame_by_hand():
    ais = files.config("aishell_streaming")
    f = files.module("flops", "cnn").frame_flops(ais)
    assert f == 2 * (5 * 80 * 384 + 3 * 5 * 384 * 384 + 384 * 4233)


@pytest.mark.parametrize("config,frames,want", [
    ("librispeech_ctc_bigru", [1598, 1, 797], [400, 1, 200]),  # ceil twice, a block each
    ("aishell_streaming", [64, 1, 191], [32, 1, 96]),  # ceil once, the first Conv1d
])
def test_encoder_frames_come_from_the_encoders_own_file(config, frames, want):
    from benchmark.flops import enc_frames

    model = files.config(config)["recipe"]["model"]
    assert enc_frames(frames, model).tolist() == want
