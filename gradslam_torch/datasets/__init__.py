"""Datasets of the PyTorch port (numpy generators; no file loaders yet)."""

from .synthetic import synthetic_sequence

__all__ = ["synthetic_sequence"]
