"""SLAM pipelines of the PyTorch port."""

from .fusionutils import (
    find_active_map_points,
    get_alpha,
    pack_colors,
    prune_map,
    unpack_colors,
    update_map_aggregate,
    update_map_fusion,
)
from .icpslam import ICPSLAM, split_prune_segments
from .pointfusion import PointFusion

__all__ = [
    "ICPSLAM",
    "PointFusion",
    "find_active_map_points",
    "get_alpha",
    "pack_colors",
    "prune_map",
    "split_prune_segments",
    "unpack_colors",
    "update_map_aggregate",
    "update_map_fusion",
]
