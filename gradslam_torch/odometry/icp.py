r"""Point-to-plane ICP odometry provider with the LM solver (PyTorch).

Counterpart of ``gradslam_tpu/odometry/icp.py:23-113``. The JAX provider
``vmap``-s one cloud pair's solve over the batch; here the batch is a
leading dimension of every tensor and all sequences solve at once.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..structures.pointclouds import Pointclouds
from .base import OdometryProvider
from .icputils import point_to_plane_ICP

__all__ = ["ICPOdometryProvider"]


class ICPOdometryProvider(OdometryProvider):
    r"""ICP odometry using the point-to-plane error and the classic LM
    accept/reject solver, with the lookahead reuse, the robust kernel and
    the normal gate."""

    def __init__(
        self,
        numiters: int = 20,
        damp: float = 1e-8,
        dist_thresh: Optional[float] = None,
        lookahead_assoc: str = "fresh",
        robust_loss: Optional[str] = None,
        robust_scale: float = 0.05,
        dot_gate: Optional[float] = None,
    ):
        if dot_gate is not None and not (-1.0 <= dot_gate <= 1.0):
            raise ValueError(f"dot_gate must be a cosine in [-1, 1] or None. Got {dot_gate}.")
        self.numiters = numiters
        self.damp = damp
        self.dist_thresh = dist_thresh
        self.lookahead_assoc = lookahead_assoc
        self.robust_loss = robust_loss
        self.robust_scale = robust_scale
        self.dot_gate = dot_gate

    def provide(
        self,
        maps_pointclouds: Pointclouds,
        frames_pointclouds: Pointclouds,
        initial_transform: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        r"""Relative transforms ``(B, 1, 4, 4)`` aligning each live-frame
        cloud to its map cloud; ``initial_transform (B, 4, 4)`` warm-starts
        the solve (for example from a coarser pyramid level) and is included
        in the result. With ``dot_gate`` the frame cloud's normals are the
        gate's source normals."""
        if maps_pointclouds.normals is None:
            raise ValueError(
                "maps_pointclouds missing normals. Map normals must be provided "
                "if using ICPOdometryProvider."
            )
        if len(maps_pointclouds) != len(frames_pointclouds):
            raise ValueError(
                "Batch size of maps_pointclouds and frames_pointclouds should be "
                f"equal ({len(maps_pointclouds)} != {len(frames_pointclouds)})."
            )
        if self.dot_gate is not None and frames_pointclouds.normals is None:
            raise ValueError(
                "dot_gate requires frames_pointclouds normals (the source "
                "normals the gate compares against the map's)."
            )
        transform, _ = point_to_plane_ICP(
            frames_pointclouds.points,
            maps_pointclouds.points,
            maps_pointclouds.normals,
            initial_transform=initial_transform,
            numiters=self.numiters,
            damp=self.damp,
            dist_thresh=self.dist_thresh,
            src_mask=frames_pointclouds.nonpad_mask,
            tgt_mask=maps_pointclouds.nonpad_mask,
            lookahead_assoc=self.lookahead_assoc,
            robust_loss=self.robust_loss,
            robust_scale=self.robust_scale,
            src_normals=None if self.dot_gate is None else frames_pointclouds.normals,
            dot_gate=self.dot_gate,
        )
        return transform[:, None]
