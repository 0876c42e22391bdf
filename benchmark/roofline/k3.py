"""K3, the CTC forward recursion (``csrc/ctc_alpha.cu``): S = 2U + 1 states
over T frames for B utterances (the labels padded to max_label_len).
Bytes: the emissions read and the alpha trajectory written, lengths and
label masks; about 20 f32 operations a live state-step."""

from benchmark.roofline.common import bound_s as _bound

SYMBOLS = ("ctc_alpha_kernel",)
LOOPS = ("train",)


def work(T: int, B: int, S: int, steps: int) -> tuple[float, float]:
    tb = T * B * S * 4
    return 2 * tb + 4 * (T * B + 2 * B * S), 20 * steps * S


def bound_s(call: dict, conf: dict, peaks: dict) -> float:
    S = 2 * call["U"] + 1
    return _bound(*work(call["T_enc"], call["B"], S, sum(call["enc_lengths"])), "float32", peaks)
