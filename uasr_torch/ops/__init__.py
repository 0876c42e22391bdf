"""Decoding, the CTC prefix-beam kernel (K4) and edit distance."""
