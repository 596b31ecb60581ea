"""Utilities of the PyTorch port."""

from .precision import disable_tf32, tf32_disabled

__all__ = ["disable_tf32", "tf32_disabled"]
