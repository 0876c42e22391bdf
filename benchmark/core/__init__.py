"""The harness's shared parts: finding a cell's files by name (``files``),
drawing weights from the seed (``weights``), the profiler trace and what
is read from it (``trace``), and the result line (``result``)."""
