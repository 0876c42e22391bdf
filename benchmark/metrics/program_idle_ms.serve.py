"""Device-idle ms a call while the host was inside the program's call
span: the device trace's idle gaps intersected with the calls' spans
(``core/spans.py``); the rest of the idle time is the caller's."""

from benchmark.core import spans


def read(ctx):
    return spans.program_idle_ms(ctx)
