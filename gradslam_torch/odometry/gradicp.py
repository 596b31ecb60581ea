r"""GradICP odometry provider (PyTorch).

Counterpart of ``gradslam_tpu/odometry/gradicp.py:26-125``: the gradLM solver
with the reference's parameters (lambda_max=2.0, B=1.0, B2=1.0, nu=200.0),
the lookahead reuse, the robust kernel and the normal gate, solved for the
whole batch at once.
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
        self.lambda_max = lambda_max
        self.B = B
        self.B2 = B2
        self.nu = nu
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
                "if using GradICPOdometryProvider."
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
            lookahead_assoc=self.lookahead_assoc,
            robust_loss=self.robust_loss,
            robust_scale=self.robust_scale,
            src_normals=None if self.dot_gate is None else frames_pointclouds.normals,
            dot_gate=self.dot_gate,
        )
        return transform[:, None]
