"""Acoustic frontend: features, the fused log-mel kernel (K1) and its constants."""
