r"""Ground-truth odometry provider (counterpart of
``gradslam_tpu/odometry/groundtruth.py:13``)."""

from __future__ import annotations

import torch

from ..geometry.geometryutils import relative_transformation
from ..structures.rgbdimages import RGBDImages
from .base import OdometryProvider

__all__ = ["GroundTruthOdometryProvider"]


class GroundTruthOdometryProvider(OdometryProvider):
    r"""The relative transform ``inv(T1) @ T2`` between two posed frame
    batches."""

    def provide(self, rgbdimages1: RGBDImages, rgbdimages2: RGBDImages) -> torch.Tensor:
        """``inv(poses1) @ poses2`` of two sequence-length-1 posed frame
        batches, shape ``(B, 1, 4, 4)``."""
        if not isinstance(rgbdimages1, RGBDImages) or not isinstance(rgbdimages2, RGBDImages):
            raise TypeError("Expected rgbdimages of type RGBDImages.")
        if rgbdimages1.shape[1] != 1 or rgbdimages2.shape[1] != 1:
            raise ValueError("Expected rgbdimages to have sequence length of 1.")
        if len(rgbdimages1) != len(rgbdimages2):
            raise ValueError(
                "Batch sizes of rgbdimages1 and rgbdimages2 must be equal "
                f"({len(rgbdimages1)} != {len(rgbdimages2)})."
            )
        if rgbdimages1.poses is None or rgbdimages2.poses is None:
            raise ValueError("Both rgbdimages must have poses.")
        return relative_transformation(rgbdimages1.poses, rgbdimages2.poses)
