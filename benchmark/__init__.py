"""The PyTorch and CUDA port's benchmark (see run.py and PERF.md)."""
