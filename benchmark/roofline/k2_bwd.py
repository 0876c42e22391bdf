"""K2-bwd, the BiGRU recurrence backward (``csrc/bigru_bwd.cu``: the
coefficient kernel and the reverse chain), once per GRU layer. Bytes: the
input projections, wh and bh, the outputs and their gradients, the
projections' gradients and the carried states; operations: the gate
product at every row-step and the chain's product at the live ones."""

from benchmark.roofline.common import bound_s as _bound
from benchmark.roofline.common import model_dtype

SYMBOLS = ("coeffs_kernel", "chain_kernel")
LOOPS = ("train",)


def work(T: int, B: int, H: int, steps: int, esize: int) -> tuple[float, float]:
    nbytes = (esize * (2 * T * B * 3 * H + 2 * H * 3 * H + 2 * 3 * H + 2 * T * B * 2 * H
                       + 2 * T * B * 3 * H + 2 * T * B * H) + 4 * T * 2 * B)
    return nbytes, 2 * (T * 2 * B + steps) * H * 3 * H


def bound_s(call: dict, conf: dict, peaks: dict) -> float:
    m, dt = conf["recipe"]["model"], model_dtype(conf)
    steps = 2 * sum(call["enc_lengths"])
    one = _bound(*work(call["T_enc"], call["B"], m["hidden_size"], steps,
                       2 if dt == "bfloat16" else 4), dt, peaks)
    return m["num_gru_layers"] * one
