r"""GradICP odometry provider (PyTorch).

Counterpart of ``gradslam_tpu/odometry/gradicp.py``: the gradLM solver with
the reference's parameters (lambda_max=2.0, B=1.0, B2=1.0, nu=200.0), solved
for the whole batch at once.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..structures.pointclouds import Pointclouds
from .base import OdometryProvider
from .icputils import point_to_plane_gradICP

__all__ = ["GradICPOdometryProvider"]


class GradICPOdometryProvider(OdometryProvider):
    r"""Differentiable ICP with the gradLM solver."""

    def __init__(
        self,
        numiters: int = 20,
        damp: float = 1e-8,
        dist_thresh: Optional[float] = None,
        lambda_max: float = 2.0,
        B: float = 1.0,
        B2: float = 1.0,
        nu: float = 200.0,
    ):
        self.numiters = numiters
        self.damp = damp
        self.dist_thresh = dist_thresh
        self.lambda_max = lambda_max
        self.B = B
        self.B2 = B2
        self.nu = nu

    def provide(
        self,
        maps_pointclouds: Pointclouds,
        frames_pointclouds: Pointclouds,
        initial_transform: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        r"""Relative transforms ``(B, 1, 4, 4)`` aligning each live-frame
        cloud to its map cloud; ``initial_transform (B, 4, 4)`` warm-starts
        the solve and is included in the result."""
        if maps_pointclouds.normals is None:
            raise ValueError(
                "maps_pointclouds missing normals. Map normals must be provided "
                "if using GradICPOdometryProvider."
            )
        if len(maps_pointclouds) != len(frames_pointclouds):
            raise ValueError(
                "Batch size of maps_pointclouds and frames_pointclouds should be "
                f"equal ({len(maps_pointclouds)} != {len(frames_pointclouds)})."
            )
        transform, _ = point_to_plane_gradICP(
            frames_pointclouds.points,
            maps_pointclouds.points,
            maps_pointclouds.normals,
            initial_transform=initial_transform,
            numiters=self.numiters,
            damp=self.damp,
            dist_thresh=self.dist_thresh,
            lambda_max=self.lambda_max,
            B=self.B,
            B2=self.B2,
            nu=self.nu,
            src_mask=frames_pointclouds.nonpad_mask,
            tgt_mask=maps_pointclouds.nonpad_mask,
        )
        return transform[:, None]
