"""SLAM pipelines of the PyTorch port."""

from .fusionutils import (
    find_active_map_points,
    get_alpha,
    pack_colors,
    prune_map,
    unpack_colors,
    update_map_aggregate,
    update_map_fusion,
    voxel_downsample,
)
from .health import keyframe_anchor, tracking_health
from .icpslam import ICPSLAM, split_prune_segments
from .pointfusion import PointFusion
from .relocalize import perturbation_grid, relocalize

__all__ = [
    "ICPSLAM",
    "PointFusion",
    "find_active_map_points",
    "get_alpha",
    "keyframe_anchor",
    "pack_colors",
    "perturbation_grid",
    "prune_map",
    "relocalize",
    "split_prune_segments",
    "tracking_health",
    "unpack_colors",
    "update_map_aggregate",
    "update_map_fusion",
    "voxel_downsample",
]
