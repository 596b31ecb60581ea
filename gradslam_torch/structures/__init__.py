"""Data structures of the PyTorch port."""

from .io import load_ply, save_ply
from .pointclouds import Pointclouds, compact_masked
from .rgbdimages import RGBDImages
from .structutils import (
    animation_slider,
    animation_updatemenus,
    coerce_torch,
    img_to_b64str,
    list_to_padded,
    numpy_to_plotly_image,
    padded_to_list,
    plotly_image_hovertemplate,
)
from .utils import estimate_normals, pointclouds_from_rgbdimages

__all__ = [
    "Pointclouds",
    "RGBDImages",
    "animation_slider",
    "animation_updatemenus",
    "coerce_torch",
    "compact_masked",
    "estimate_normals",
    "img_to_b64str",
    "list_to_padded",
    "load_ply",
    "numpy_to_plotly_image",
    "padded_to_list",
    "plotly_image_hovertemplate",
    "pointclouds_from_rgbdimages",
    "save_ply",
]
