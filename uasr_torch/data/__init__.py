"""Batch container of the decode path."""
