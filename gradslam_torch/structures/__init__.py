"""Data structures of the PyTorch port."""

from .io import load_ply, save_ply
from .pointclouds import Pointclouds, compact_masked
from .rgbdimages import RGBDImages
from .utils import estimate_normals, pointclouds_from_rgbdimages

__all__ = [
    "Pointclouds",
    "RGBDImages",
    "compact_masked",
    "estimate_normals",
    "load_ply",
    "pointclouds_from_rgbdimages",
    "save_ply",
]
