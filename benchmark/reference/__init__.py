"""Plain PyTorch reference of the benchmarked paths, in float32 with TF32 off.

It imports nothing of the program under test and nothing of JAX: the
log-mel frontend with utterance and streaming CMVN (``fbank``), SpecAugment's
band draws (``specaug``), the conv2d front with the BiGRU and the ``cnn``
encoder (``models``), the CTC loss and likelihood (``ctc``), clipped Adam
with the recipes' schedule (``adam``) and the exact CTC prefix beam
(``beam``). ``precision.Cast`` rounds the operands of every product, which
turns the reference into the lower-precision control.
"""
