"""K7, the streaming log-mel frontend (``csrc/log_mel.cu``, unfused):
each streaming slot's glued chunk of (FL - FS) + chunk samples to the
chunk's frames. Counted over the slots that stream this tick (the others'
rows are computed and dropped). Operations add the pre-emphasis pass."""

from benchmark.roofline.common import bound_s as _bound
from benchmark.roofline.common import frontend_dims

SYMBOLS = ("log_mel_kernel",)
LOOPS = ("stream",)


def work(B: int, L: int, T: int, d: dict) -> tuple[float, float]:
    FL, NB, M = d["FL"], d["NB"], d["M"]
    nbytes = 4 * (B * L + FL + 2 * FL * NB + NB * M + B * T * M)
    ops = B * T * FL + 2 * B * T * FL * 2 * NB + 2 * B * T * d["nnz"]
    return nbytes, ops


def bound_s(call: dict, conf: dict, peaks: dict) -> float:
    d = frontend_dims(conf["recipe"]["frontend"])
    T = call["chunk_samples"] // d["FS"]
    return _bound(*work(call["stepped"], d["FL"] - d["FS"] + call["chunk_samples"], T, d),
                  "float32", peaks)
