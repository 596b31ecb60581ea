"""Datasets of the PyTorch port (numpy generators; no file loaders yet)."""

from .synthetic import hard_sequence, synthetic_sequence

__all__ = ["hard_sequence", "synthetic_sequence"]
