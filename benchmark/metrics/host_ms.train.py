"""Host ms a call inside the program's own call span (``train.step``,
``stream.tick``, ``infer.request``), over the calls traced with device
activity alone (``core/spans.py``)."""

from benchmark.core import spans


def read(ctx):
    return spans.host_ms(ctx)
