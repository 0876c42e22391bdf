"""Per-layer metric readers, one a file, found by the metric's name in
BENCHMARK.json. ``read(ctx)`` takes a ``core.readers.Context`` and returns
a number, or None when it finds nothing to read."""
