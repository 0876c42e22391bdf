"""K3-bwd, the CTC backward recursion (``csrc/ctc_beta.cu``): reads the
emissions and alpha, writes the emission gradients; about 24 f32
operations a live state-step."""

from benchmark.roofline.common import bound_s as _bound

SYMBOLS = ("ctc_beta_kernel",)
LOOPS = ("train",)


def work(T: int, B: int, S: int, steps: int) -> tuple[float, float]:
    tb = T * B * S * 4
    return 3 * tb + 4 * (T * B + 2 * B * S + 2 * B), 24 * steps * S


def bound_s(call: dict, conf: dict, peaks: dict) -> float:
    S = 2 * call["U"] + 1
    return _bound(*work(call["T_enc"], call["B"], S, sum(call["enc_lengths"])), "float32", peaks)
