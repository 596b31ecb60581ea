"""Data structures of the PyTorch port."""

from .pointclouds import Pointclouds, compact_masked
from .rgbdimages import RGBDImages

__all__ = ["Pointclouds", "RGBDImages", "compact_masked"]
