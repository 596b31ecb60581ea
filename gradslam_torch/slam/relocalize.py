r"""Relocalization: re-attach a lost frame to the map by solving ICP from
several hypothesis poses and keeping the one that scores best.

Counterpart of ``gradslam_tpu/slam/relocalize.py``: ``perturbation_grid``
(:66) and ``relocalize`` (:107). Each hypothesis runs the tracker's own
pipeline (project the map, compact its stride-``ds`` window, downsample the
frame, solve point-to-plane ICP) and is scored with the tracking-health
statistic at its solved pose (:func:`~gradslam_torch.slam.health.
_association_health`). The JAX package ``vmap``-s or ``lax.scan``-s the
hypothesis axis; here ``'vmap'`` folds the K hypotheses into the batch (one
1-NN launch an iteration covers all ``B * K`` rows, hypothesis ``k`` of
sequence ``b`` at row ``b * K + k``) and ``'scan'`` is a Python loop over K
with one hypothesis's buffers live at a time. The two give the same poses.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import torch

from ..geometry.geometryutils import compose_transformations, orthonormalize_rotations
from ..geometry.se3utils import se3_exp
from ..odometry.gradicp import GradICPOdometryProvider
from ..odometry.icp import ICPOdometryProvider
from ..odometry.icputils import downsample_pointclouds, downsample_rgbdimages
from ..structures.pointclouds import Pointclouds
from ..structures.rgbdimages import RGBDImages
from .fusionutils import find_active_map_points
from .health import _association_health

__all__ = ["perturbation_grid", "relocalize"]

_YAW_DEG = (0.0, -15.0, 15.0, -30.0, 30.0)  # perturbation_grid's defaults
_TRANSLATIONS = ((0.0, 0.0, 0.0),)


def perturbation_grid(
    poses: torch.Tensor,
    *,
    yaw_deg: Sequence[float] = _YAW_DEG,
    translations: Sequence[Sequence[float]] = _TRANSLATIONS,
) -> torch.Tensor:
    r"""A camera-local hypothesis grid around ``poses (B, 4, 4)``
    (camera-to-world): every translation offset (metres, camera frame:
    x right, y down, z forward) with every yaw (degrees, about the camera's
    y axis), composed on the camera side (``pose @ delta``). Returns
    ``(B, K, 4, 4)`` with ``K = len(yaw_deg) * len(translations)``, the yaws
    varying fastest; hypothesis 0 is the pose itself when the first yaw and
    translation are zero."""
    poses = torch.as_tensor(poses)
    if poses.ndim != 3 or tuple(poses.shape[-2:]) != (4, 4):
        raise ValueError(f"poses must have shape (B, 4, 4). Got {tuple(poses.shape)}.")
    deltas = _grid_deltas(poses.dtype, poses.device, yaw_deg=yaw_deg, translations=translations)
    return _compose_grid(poses, deltas)


def _grid_deltas(dtype: torch.dtype, device, *, yaw_deg: Sequence[float] = _YAW_DEG,
                 translations: Sequence[Sequence[float]] = _TRANSLATIONS) -> torch.Tensor:
    r""":func:`perturbation_grid`'s camera-side deltas ``(K, 4, 4)``, made
    from host numbers: a copy from the host, so a caller that composes the
    grid inside a CUDA graph makes them once, outside the capture, and
    passes them in (``ICPSLAM``'s relocalization branch)."""
    if len(yaw_deg) == 0 or len(translations) == 0:
        raise ValueError("yaw_deg and translations must be non-empty.")
    xis = []
    for t in translations:
        t = tuple(float(x) for x in t)
        if len(t) != 3:
            raise ValueError(f"each translation must be a 3-sequence. Got {t}.")
        for yd in yaw_deg:
            xis.append(t + (0.0, math.radians(float(yd)), 0.0))  # twist (v, omega)
    return se3_exp(torch.tensor(xis, dtype=dtype, device=device))


def _compose_grid(poses: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """The grid ``(B, K, 4, 4)``: ``poses (B, 4, 4)`` composed with each of
    the ``deltas (K, 4, 4)`` on the camera side."""
    return torch.einsum("bij,kjl->bkil", poses, deltas)


def _fold(x: torch.Tensor, K: int) -> torch.Tensor:
    """``x (B, ...)`` repeated K times along a new axis after the batch and
    folded into it: ``(B * K, ...)``, row ``b * K + k``. A view for B = 1."""
    return x[:, None].expand(x.shape[0], K, *x.shape[1:]).reshape(x.shape[0] * K, *x.shape[1:])


def relocalize(
    pointclouds: Pointclouds,
    live_frame: RGBDImages,
    anchor_poses: torch.Tensor,
    *,
    odom: str = "gradicp",
    dsratio: int = 8,
    numiters: int = 12,
    damp: float = 1e-8,
    dist_thresh: Optional[float] = None,
    robust_scale: float = 0.05,
    icp_capacity: Optional[int] = None,
    hypothesis_mode: str = "vmap",
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    r"""Solve ICP from every hypothesis pose, score each solution with the
    tracking-health statistic, and return the best.

    Args:
        pointclouds: the map (with normals); it is not modified.
        live_frame: sequence-length-1 frame; its own poses are ignored.
        anchor_poses: ``(B, K, 4, 4)`` hypotheses, e.g. a
            :func:`perturbation_grid` around the last healthy pose.
        odom: ``'gradicp'`` (gradLM) or ``'icp'`` (LM).
        dsratio, numiters, damp, dist_thresh: the solves' controls (plain
            least squares: a robust kernel would reject exactly the far-off
            starts recovery has to pull in).
        robust_scale: the health inlier band that scores the solutions.
        icp_capacity: map-window capacity of each hypothesis (default
            ``2 * ceil(H / ds) * ceil(W / ds)``).
        hypothesis_mode: ``'vmap'`` solves the K hypotheses as one batch of
            ``B * K``; ``'scan'`` solves them one after another.

    Returns:
        ``(poses (B, 1, 4, 4), info)``: the best-scoring solved pose of each
        sequence (rotation re-projected onto SO(3)); ``info`` holds the
        winner's ``inlier_frac (B,)``, ``best_hypothesis (B,)`` (the first
        maximum on ties) and every ``hypothesis_inlier_frac (B, K)``.
    """
    if not isinstance(pointclouds, Pointclouds):
        raise TypeError(
            f"Expected pointclouds to be of type Pointclouds. Got {type(pointclouds)}."
        )
    if not isinstance(live_frame, RGBDImages):
        raise TypeError(
            f"Expected live_frame to be of type RGBDImages. Got {type(live_frame)}."
        )
    if pointclouds.normals is None:
        raise ValueError(
            "relocalize needs map normals (point-to-plane solves); the map has none."
        )
    anchor_poses = torch.as_tensor(anchor_poses)
    B = len(pointclouds)
    if (anchor_poses.ndim != 4 or anchor_poses.shape[0] != B
            or tuple(anchor_poses.shape[-2:]) != (4, 4)):
        raise ValueError(
            f"anchor_poses must have shape (B, K, 4, 4) = ({B}, K, 4, 4). "
            f"Got {tuple(anchor_poses.shape)}."
        )
    if odom == "gradicp":
        prov = GradICPOdometryProvider(numiters, damp, dist_thresh)
    elif odom == "icp":
        prov = ICPOdometryProvider(numiters, damp, dist_thresh)
    else:
        raise ValueError(f"Unknown odom for relocalize: {odom!r}. Expected 'gradicp' or 'icp'.")
    if hypothesis_mode not in ("vmap", "scan"):
        raise ValueError(
            f"Unknown hypothesis_mode: {hypothesis_mode!r}. Expected 'vmap' or 'scan'."
        )
    _, _, H, W = live_frame.shape
    cap = (icp_capacity if icp_capacity is not None
           else 2 * math.ceil(H / dsratio) * math.ceil(W / dsratio))
    target = Pointclouds(points=pointclouds.points, num_points=pointclouds.num_points,
                         normals=pointclouds.normals)

    def solve(tgt: Pointclouds, frame: RGBDImages, pose_k: torch.Tensor):
        """Solve and score the hypotheses ``pose_k (n, 4, 4)`` of a batch of
        ``n`` (map, frame) rows."""
        frame_h = frame.with_poses(pose_k[:, None])
        active = find_active_map_points(tgt, frame_h)
        maps_pc = downsample_pointclouds(tgt, active.valid, active.pix_h, active.pix_w,
                                         dsratio, cap)
        frames_pc = downsample_rgbdimages(frame_h, dsratio)
        transform = prov.provide(maps_pc, frames_pc)
        solved = orthonormalize_rotations(compose_transformations(transform[:, 0], pose_k))
        h = _association_health(tgt, frame.with_poses(solved[:, None]), dsratio=dsratio,
                                robust_scale=robust_scale, dist_thresh=dist_thresh,
                                icp_capacity=cap)
        return solved, h["inlier_frac"]

    K = anchor_poses.shape[1]
    if hypothesis_mode == "vmap":
        # the map and the frame are the same for every hypothesis: repeated
        # by broadcasting (a view for B = 1), copied only where an op needs
        # contiguous rows
        tgt = Pointclouds(points=_fold(target.points, K), num_points=_fold(target.num_points, K),
                          normals=_fold(target.normals, K))
        frame = dataclasses.replace(
            live_frame, rgb_image=_fold(live_frame.rgb_image, K),
            depth_image=_fold(live_frame.depth_image, K),
            intrinsics=_fold(live_frame.intrinsics, K), poses=None)
        solved, scores = solve(tgt, frame, anchor_poses.reshape(B * K, 4, 4))
        solved, scores = solved.reshape(B, K, 4, 4), scores.reshape(B, K)
    else:
        outs = [solve(target, live_frame, anchor_poses[:, k]) for k in range(K)]
        solved = torch.stack([o[0] for o in outs], dim=1)
        scores = torch.stack([o[1] for o in outs], dim=1)
    best = torch.argmax(scores, dim=1)  # the first maximum, as jnp.argmax
    rows = torch.arange(B, device=best.device)
    return solved[rows, best][:, None], {
        "inlier_frac": scores[rows, best],
        "best_hypothesis": best,
        "hypothesis_inlier_frac": scores,
    }
