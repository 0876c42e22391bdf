"""K1, the fused log-mel frontend (``csrc/log_mel.cu``): a batch of B
padded utterances of L samples to T frames of M mel bins, f32 products
(precision ``highest``). Bytes: audio, the DFT bases and boundary row,
the filterbank, the output. Operations: the two DFT products and the mel
product over the filterbank's nonzero entries."""

from benchmark.roofline.common import bound_s as _bound
from benchmark.roofline.common import frontend_dims

SYMBOLS = ("log_mel_kernel",)
LOOPS = ("train", "decode")


def work(B: int, L: int, T: int, d: dict) -> tuple[float, float]:
    FL, NB, M = d["FL"], d["NB"], d["M"]
    nbytes = 4 * (B * L + 2 * FL * NB + 2 * NB + NB * M + B * T * M)
    ops = 2 * B * T * FL * 2 * NB + 2 * B * T * d["nnz"]
    return nbytes, ops


def bound_s(call: dict, conf: dict, peaks: dict) -> float:
    d = frontend_dims(conf["recipe"]["frontend"])
    return _bound(*work(call["B"], call["L"], call["T_feat"], d), "float32", peaks)
