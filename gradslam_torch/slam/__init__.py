"""SLAM pipelines of the PyTorch port."""

from .fusionutils import find_active_map_points, get_alpha, update_map_fusion
from .icpslam import ICPSLAM
from .pointfusion import PointFusion

__all__ = [
    "ICPSLAM",
    "PointFusion",
    "find_active_map_points",
    "get_alpha",
    "update_map_fusion",
]
