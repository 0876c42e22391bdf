"""K2, the BiGRU recurrence forward (``csrc/bigru_fwd.cu``), once per GRU
layer: the work of the row-steps the masks keep live in both directions
(a masked row-step only carries h, so it needs neither its input row nor
the product); the output is written at every row-step."""

from benchmark.roofline.common import bound_s as _bound
from benchmark.roofline.common import model_dtype

SYMBOLS = ("gru_fwd_kernel",)
LOOPS = ("train", "decode")


def work(T: int, B: int, H: int, steps: int, esize: int) -> tuple[float, float]:
    nbytes = esize * (steps * 3 * H + 2 * H * 3 * H + 2 * 3 * H + T * B * 2 * H) + 4 * T * 2 * B
    return nbytes, 2 * steps * H * 3 * H


def bound_s(call: dict, conf: dict, peaks: dict) -> float:
    m, dt = conf["recipe"]["model"], model_dtype(conf)
    steps = 2 * sum(call["enc_lengths"])
    one = _bound(*work(call["T_enc"], call["B"], m["hidden_size"], steps,
                       2 if dt == "bfloat16" else 4), dt, peaks)
    return m["num_gru_layers"] * one
