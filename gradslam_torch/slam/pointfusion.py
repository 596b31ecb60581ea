r"""PointFusion pipeline (PyTorch).

Counterpart of ``gradslam_tpu/slam/pointfusion.py``: the SLAM driver with the
map update replaced by Keller et al. point-based fusion. Defaults match the
reference (``dist_th=0.05``, ``angle_th=20`` degrees, ``sigma=0.6``).
"""

from __future__ import annotations

import math
import warnings
from typing import Optional, Union

from ..structures.pointclouds import Pointclouds
from ..structures.rgbdimages import RGBDImages
from .fusionutils import update_map_fusion
from .icpslam import ICPSLAM

__all__ = ["PointFusion"]


class PointFusion(ICPSLAM):
    r"""Point-based fusion SLAM: projective data association and
    confidence-weighted map merging, with ``odom='gt'`` or ``'gradicp'``
    tracking. ``association``/``merge`` accept ``'auto'`` and the ported
    modes (``'sort_full'``, ``'gather'``); see
    :func:`~gradslam_torch.slam.fusionutils.update_map_fusion`."""

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
        if active_capacity is not None:
            raise NotImplementedError(
                "active_capacity sizes the 'windowed' association, which is not "
                "ported to gradslam_torch yet (ROADMAP.md queue 1, item 1)."
            )
        if quantize_colors:
            raise NotImplementedError(
                "quantize_colors=True is not ported to gradslam_torch yet "
                "(ROADMAP.md queue 1, item 8)."
            )
        for name, mode, ported in (
            ("association", association, "sort_full"),
            ("merge", merge, "gather"),
        ):
            if mode not in ("auto", ported):
                raise NotImplementedError(
                    f"{name}={mode!r} is not ported to gradslam_torch yet "
                    "(ROADMAP.md queue 1, item 1)."
                )
        super().__init__(**kwargs)
        if dist_th < 0:
            warnings.warn(f"Distance threshold ({dist_th}) should be non-negative.")
        if not (0 <= angle_th <= 90):
            warnings.warn(f"Angle threshold ({angle_th}) should be non-negative and <=90.")
        self.dist_th = dist_th
        self.dot_th = math.cos(angle_th * math.pi / 180.0)
        self.sigma = sigma
        self.association = association
        self.merge = merge

    def _map(self, pointclouds: Pointclouds, live_frame: RGBDImages) -> Pointclouds:
        return update_map_fusion(
            pointclouds, live_frame, self.dist_th, self.dot_th, self.sigma,
            association=self.association, merge=self.merge,
        )
