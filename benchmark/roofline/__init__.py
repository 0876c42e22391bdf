"""One kernel's least time for a call's shapes: what the algorithm needs
for these inputs, counting each input byte read once and each output
byte written once, at the card's published peaks (``peaks.json``). Each
file names the kernel's symbols in the device trace (``SYMBOLS``), the
loops whose calls launch it (``LOOPS``) and ``bound_s(call, conf,
peaks)``. The arithmetic is a copy of ``chip_smoke.py``'s ``bound()`` and
the bound column of PERF.md's kernel table."""
