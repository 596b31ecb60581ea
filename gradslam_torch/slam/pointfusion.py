r"""PointFusion pipeline (PyTorch).

Counterpart of ``gradslam_tpu/slam/pointfusion.py``: the SLAM driver with the
map update replaced by Keller et al. point-based fusion. Defaults match the
reference (``dist_th=0.05``, ``angle_th=20`` degrees, ``sigma=0.6``).
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Optional, Union

import torch

from ..structures.pointclouds import Pointclouds
from ..structures.rgbdimages import RGBDImages
from .fusionutils import unpack_colors, update_map_fusion
from .icpslam import ICPSLAM

__all__ = ["PointFusion"]


class PointFusion(ICPSLAM):
    r"""Point-based fusion SLAM: projective data association and
    confidence-weighted map merging, with ``odom='gt'``, ``'icp'`` or ``'gradicp'``
    tracking.

    Args (besides :class:`ICPSLAM`'s, which pass through, the recovery and
    projective options included; ``icp_window_frames`` is refused, as in
    the JAX package: the map merges in place, so buffer recency is not
    spatial recency):
        dist_th, angle_th, sigma: fusion gates and confidence width.
        active_capacity, association, merge: see
            :func:`~gradslam_torch.slam.fusionutils.update_map_fusion`.
        quantize_colors: keep colors as 8-bit values packed into the map's
            second feature channel (``features = [ccount, packed_color]``,
            ``colors=None``); :meth:`decode_map` turns such a map back into
            float colors. Geometry and counts are the float-color map's.
        feature_channels: user channels after the bookkeeping ones
            (``[ccount, *user]`` or ``[ccount, packed_color, *user]``), fused
            from the frames' ``feature_image`` like colors; they never change
            the geometry, colors or confidences of the map.
    """

    has_features = True  # ccounts live in the map's feature channel

    def __init__(
        self,
        *,
        dist_th: Union[float, int] = 0.05,
        angle_th: Union[float, int] = 20,
        sigma: Union[float, int] = 0.6,
        active_capacity: Optional[int] = None,
        association: str = "auto",
        merge: str = "auto",
        quantize_colors: bool = False,
        **kwargs,
    ):
        if kwargs.get("icp_window_frames") is not None:
            raise ValueError(
                "icp_window_frames is not supported by PointFusion: its map merges in place, "
                "so buffer recency does not mean spatial recency. Use it with ICPSLAM's "
                "append-ordered map, or rely on PointFusion's bounded map size instead."
            )
        if association not in ("auto", "sort_full", "windowed"):
            raise ValueError(f"Unknown association mode: {association!r}")
        if merge not in ("auto", "gather", "scatter"):
            raise ValueError(f"Unknown merge mode: {merge!r}")
        super().__init__(**kwargs)
        if dist_th < 0:
            warnings.warn(f"Distance threshold ({dist_th}) should be non-negative.")
        if not (0 <= angle_th <= 90):
            warnings.warn(f"Angle threshold ({angle_th}) should be non-negative and <=90.")
        self.dist_th = dist_th
        self.dot_th = math.cos(angle_th * math.pi / 180.0)
        self.sigma = sigma
        self.active_capacity = active_capacity
        self.association = association
        self.merge = merge
        self.quantize_colors = bool(quantize_colors)

    @property
    def _map_has_colors(self) -> bool:
        return not self.quantize_colors

    @property
    def _map_feature_dim(self) -> int:
        return (2 if self.quantize_colors else 1) + self.feature_channels

    @staticmethod
    def decode_map(pointclouds: Pointclouds) -> Pointclouds:
        r"""Float colors ``(B, CAP, 3)`` and features ``[ccount, *user]``
        from a quantized map (``[ccount, packed_color, *user]``); a
        float-color map is returned as it is."""
        feats = pointclouds.features
        if pointclouds.colors is not None or feats is None or feats.shape[-1] < 2:
            return pointclouds
        return dataclasses.replace(
            pointclouds,
            colors=unpack_colors(feats[..., 1:2]),
            features=torch.cat([feats[..., :1], feats[..., 2:]], dim=-1),
        )

    def _map(self, pointclouds: Pointclouds, live_frame: RGBDImages) -> Pointclouds:
        return update_map_fusion(
            pointclouds, live_frame, self.dist_th, self.dot_th, self.sigma,
            active_capacity=self.active_capacity,
            association=self.association, merge=self.merge,
        )
