"""Encoder modules and the BiGRU forward kernel (K2)."""
