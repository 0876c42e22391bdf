"""K4, the exact CTC prefix beam (``csrc/ctc_beam.cu``): the work of the
steps the lengths keep active (the W V extensions, the fold, one top-W
pass of about two comparisons per candidate over the W V + W candidates,
the rebuild), and the bytes of the rows' log-probs, lengths, backpointers
and state. Offline: one launch a request over its B rows of T frames. A
streaming tick: one launch over the region (T = chunk / subsample) of the
slots that decode this tick, and one over the finishing slots' last
region."""

from benchmark.flops import enc_frames
from benchmark.roofline.common import bound_s as _bound

SYMBOLS = ("ctc_beam_kernel",)
LOOPS = ("decode", "stream")


def work(T: int, B: int, W: int, V: int, steps: int) -> tuple[float, float]:
    K = W * V + W
    ops = steps * (W * V * 2 + 8 * W + 6 * W * W + 2 * K + 20 * W)
    nbytes = 4 * (B * T * V + B + 2 * T * B * W + 2 * 6 * B * W)
    return nbytes, ops


def bound_s(call: dict, conf: dict, peaks: dict) -> float:
    W, V = conf["recipe"]["ctc"]["beam_width"], conf["vocab_size"]
    if "T_enc" in call:
        steps = sum(min(n, call["T_enc"]) for n in call["enc_lengths"])
        return _bound(*work(call["T_enc"], call["B"], W, V, steps), "float32", peaks)
    m, fe = conf["recipe"]["model"], conf["recipe"]["frontend"]
    T = int(enc_frames(fe["streaming_chunk_frames"], m))
    t = 0.0
    if call["step_frames"]:
        t += _bound(*work(T, call["step_rows"], W, V, call["step_frames"]), "float32", peaks)
    if call["finished"] and call["finish_frames"]:
        t += _bound(*work(T, call["finished"], W, V, call["finish_frames"]), "float32", peaks)
    return t
