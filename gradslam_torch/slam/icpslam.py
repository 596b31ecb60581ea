r"""ICP-SLAM pipeline base (PyTorch).

Counterpart of ``gradslam_tpu/slam/icpslam.py``: the constructor for the
options this port supports, ``_capacity_schedule`` (:755),
``_default_icp_capacity`` (:776), ``empty_map`` (:794), ``_icp_target_window``
(:816, no recency window), ``_localize`` (:850, single-level) and
``_forward_impl`` (:1217) — its ground-truth branch and its tracked branch
without the relocalization, keyframe-anchor and constant-velocity paths.

The JAX ``lax.scan`` over frames is a Python loop here. The capacity
schedule is static and host-side; nothing inside the frame or solver loops
reads a value back from the device.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from ..geometry.geometryutils import compose_transformations
from ..odometry.gradicp import GradICPOdometryProvider
from ..odometry.icputils import downsample_pointclouds, downsample_rgbdimages
from ..structures.pointclouds import Pointclouds
from ..structures.rgbdimages import RGBDImages
from ..utils.precision import disable_tf32
from .fusionutils import find_active_map_points

__all__ = ["ICPSLAM"]

# Options of the JAX pipelines that this port does not carry yet, with the
# value that means "off" and the ROADMAP.md item that will port them.
_UNPORTED = {
    "odom_assoc": ("knn", "queue 1, item 6 (projective odometry)"),
    "odom_angle_gate": (None, "queue 1, item 4 (robust kernels and gates)"),
    "odom_sym_normals": (False, "queue 1, item 6 (projective odometry)"),
    "odom_point_weight": (0.0, "queue 1, item 6 (projective odometry)"),
    "odom_subpixel": (False, "queue 1, item 6 (projective odometry)"),
    "pyramid": (None, "queue 1, item 3 (pyramids, windows and lookahead reuse)"),
    "robust_loss": (None, "queue 1, item 4 (robust kernels and gates)"),
    "robust_scale": (0.05, "queue 1, item 4 (robust kernels and gates)"),
    "icp_window_frames": (None, "queue 1, item 3 (pyramids, windows and lookahead reuse)"),
    "motion_model": ("static", "queue 1, item 5 (constant-velocity model)"),
    "lookahead_assoc": ("fresh", "queue 1, item 3 (pyramids, windows and lookahead reuse)"),
    "prune_every": (0, "queue 1, item 8 (quantized colors, prune and features)"),
    "prune_min_confidence": (1.0, "queue 1, item 8 (quantized colors, prune and features)"),
    "feature_channels": (0, "queue 1, item 8 (quantized colors, prune and features)"),
    "relocalize_below": (0.0, "queue 1, item 7 (recovery)"),
    "relocalize_grid": (None, "queue 1, item 7 (recovery)"),
    "relocalize_dsratio": (8, "queue 1, item 7 (recovery)"),
    "relocalize_numiters": (12, "queue 1, item 7 (recovery)"),
    "anchor_every": (0, "queue 1, item 7 (recovery)"),
    "anchor_below": (0.98, "queue 1, item 7 (recovery)"),
    "anchor_dsratio": (None, "queue 1, item 7 (recovery)"),
    "remat": (False, "queue 1, item 10 (differentiability)"),
}


def _reject_unported(options: dict) -> None:
    for name, value in options.items():
        off, item = _UNPORTED[name]
        if value != off:
            raise NotImplementedError(
                f"{name}={value!r} is not ported to gradslam_torch yet "
                f"(ROADMAP.md {item})."
            )


class ICPSLAM(nn.Module):
    r"""Frame-to-map SLAM driver. Use :class:`~gradslam_torch.PointFusion`:
    the aggregate map of the JAX ``ICPSLAM`` (``update_map_aggregate``) is
    not ported yet, so this class serves as PointFusion's base.

    Args:
        odom: ``'gt'`` (fuse at the frames' poses) or ``'gradicp'``
            (frame-to-map gradLM ICP).
        dsratio, numiters, damp, dist_thresh: ICP solver parameters.
        lambda_max, B, B2, nu: gradLM parameters.
        map_capacity: map buffer capacity, a fixed int (default
            ``L * H * W``) or a growth schedule ``[(frames, capacity), ...]``;
            the map is zero-padded between segments. The returned map's
            ``num_dropped`` counts rows lost to a full buffer.
        icp_capacity: capacity of the downsampled ICP target buffer
            (default ``2 * ceil(H / ds) * ceil(W / ds)``).
        normal_pitch: finite-difference baseline of the frames' normal maps
            (None keeps the frames' own).

    The JAX pipeline's other options raise ``NotImplementedError`` unless
    left at their defaults.
    """

    has_features = False

    def __init__(
        self,
        *,
        odom: str = "gradicp",
        dsratio: int = 4,
        numiters: int = 20,
        damp: float = 1e-8,
        dist_thresh: Optional[float] = None,
        lambda_max: float = 2.0,
        B: float = 1.0,
        B2: float = 1.0,
        nu: float = 200.0,
        map_capacity=None,
        icp_capacity: Optional[int] = None,
        normal_pitch: Optional[int] = None,
        **unported,
    ):
        super().__init__()
        unknown = set(unported) - set(_UNPORTED)
        if unknown:
            raise TypeError(f"Unknown option(s): {sorted(unknown)}.")
        _reject_unported(unported)
        if odom == "icp":
            raise NotImplementedError(
                "odom='icp' is not ported to gradslam_torch yet "
                "(ROADMAP.md queue 1, item 2)."
            )
        if odom not in ("gt", "gradicp"):
            raise ValueError(
                f"Odometry method ({odom}) not supported. Supported: 'gt', 'gradicp'."
            )
        if not self.has_features:
            raise NotImplementedError(
                "ICPSLAM's aggregate map (update_map_aggregate) is not ported "
                "to gradslam_torch yet (ROADMAP.md queue 1, item 1); use PointFusion."
            )
        if not isinstance(dsratio, int) or dsratio < 1:
            raise ValueError(f"dsratio must be an int >= 1. Got {dsratio}.")
        if not isinstance(numiters, int) or numiters < 1:
            raise ValueError(f"numiters must be an int >= 1. Got {numiters}.")
        if normal_pitch is not None and (
            not isinstance(normal_pitch, int) or normal_pitch < 1
        ):
            raise ValueError(f"normal_pitch must be None or an int >= 1. Got {normal_pitch!r}.")
        disable_tf32()
        self.odom = odom
        self.dsratio = dsratio
        self.map_capacity = map_capacity
        self.icp_capacity = icp_capacity
        self.normal_pitch = normal_pitch
        self.odomprov = (
            GradICPOdometryProvider(numiters, damp, dist_thresh, lambda_max, B, B2, nu)
            if odom == "gradicp" else None
        )

    # ------------------------------------------------------------------ #
    # Map layout and capacities (host-side, static)
    # ------------------------------------------------------------------ #
    def _capacity_schedule(self, frames: RGBDImages):
        """``map_capacity`` as ``[(frames, capacity), ...]``."""
        _, L, H, W = frames.shape
        cap = self.map_capacity
        if cap is None:
            return [(L, L * H * W)]
        if isinstance(cap, int):
            return [(L, cap)]
        sched = [(int(n), int(c)) for n, c in cap]
        if any(n <= 0 or c <= 0 for n, c in sched):
            raise ValueError(f"Invalid capacity schedule: {sched}.")
        if sum(n for n, _ in sched) != L:
            raise ValueError(
                f"Capacity schedule covers {sum(n for n, _ in sched)} frames "
                f"but the sequence has {L}."
            )
        caps = [c for _, c in sched]
        if any(c2 < c1 for c1, c2 in zip(caps, caps[1:])):
            raise ValueError(f"Capacity schedule must be non-decreasing. Got {caps}.")
        return sched

    def _default_icp_capacity(self, H: int, W: int) -> int:
        if self.icp_capacity is not None:
            return self.icp_capacity
        return 2 * math.ceil(H / self.dsratio) * math.ceil(W / self.dsratio)

    def empty_map(
        self, batch_size: int, capacity: int, *, device, dtype=torch.float32
    ) -> Pointclouds:
        r"""An empty map buffer for this pipeline on ``device``."""
        return Pointclouds.empty(
            batch_size, capacity, device=device, dtype=dtype,
            has_normals=True, has_colors=True,
            feature_dim=1 if self.has_features else None,
        )

    def _map(self, pointclouds: Pointclouds, live_frame: RGBDImages) -> Pointclouds:
        raise NotImplementedError

    def _with_normal_pitch(self, frames: RGBDImages) -> RGBDImages:
        if self.normal_pitch is None or frames.normal_pitch == self.normal_pitch:
            return frames
        return RGBDImages(
            frames.rgb_image, frames.depth_image, frames.intrinsics, frames.poses,
            normal_pitch=self.normal_pitch,
        )

    # ------------------------------------------------------------------ #
    # Odometry
    # ------------------------------------------------------------------ #
    def _icp_target_window(self, pointclouds: Pointclouds) -> Pointclouds:
        """Geometry-only view of the map (the solver reads no colors or
        features)."""
        return Pointclouds(
            points=pointclouds.points,
            num_points=pointclouds.num_points,
            normals=pointclouds.normals,
        )

    def _localize(
        self, pointclouds: Pointclouds, live_frame: RGBDImages, prev_frame: RGBDImages
    ) -> torch.Tensor:
        r"""Align the live frame against the downsampled active map; returns
        poses ``(B, 1, 4, 4)``."""
        _, _, H, W = live_frame.shape
        live_frame = live_frame.with_poses(prev_frame.poses)
        target = self._icp_target_window(pointclouds)
        active = find_active_map_points(target, prev_frame)
        maps_pc = downsample_pointclouds(
            target, active.valid, active.pix_h, active.pix_w,
            self.dsratio, self._default_icp_capacity(H, W),
        )
        frames_pc = downsample_rgbdimages(live_frame, self.dsratio)
        transform = self.odomprov.provide(maps_pc, frames_pc)
        return compose_transformations(transform[:, 0], prev_frame.poses[:, 0])[:, None]

    # ------------------------------------------------------------------ #
    # Forward
    # ------------------------------------------------------------------ #
    def forward(self, frames: RGBDImages) -> Tuple[Pointclouds, torch.Tensor]:
        r"""Run SLAM over a batch of sequences. Returns ``(pointclouds,
        poses (B, L, 4, 4))``."""
        if not isinstance(frames, RGBDImages):
            raise TypeError(f"Expected frames to be of type RGBDImages. Got {type(frames)}.")
        if self.odom == "gt" and frames.poses is None:
            raise ValueError("`frames` must have poses when `odom='gt'`.")
        frames = self._with_normal_pitch(frames)
        B, L, _, _ = frames.shape
        schedule = self._capacity_schedule(frames)
        map_pc = self.empty_map(B, schedule[0][1], device=frames.device, dtype=frames.dtype)

        if self.odom == "gt":
            s = 0
            for n, cap_seg in schedule:
                map_pc = map_pc.with_capacity(cap_seg)
                for i in range(s, s + n):
                    map_pc = self._map(map_pc, frames[:, i])
                s += n
            return map_pc, frames.poses

        # Tracked: bootstrap frame 0 at the provided (or identity) pose,
        # then track frame to map, each solve starting at the previous pose.
        if frames.poses is not None:
            prev_pose = frames.poses[:, 0]
        else:
            prev_pose = torch.eye(4, dtype=frames.dtype, device=frames.device).expand(B, 4, 4)
        poses = [prev_pose]
        map_pc = self._map(map_pc, frames[:, 0].with_poses(prev_pose[:, None]))
        f = 1
        for i, (n, cap_seg) in enumerate(schedule):
            map_pc = map_pc.with_capacity(cap_seg)
            for _ in range(n - 1 if i == 0 else n):
                live = RGBDImages(
                    frames.rgb_image[:, f:f + 1], frames.depth_image[:, f:f + 1],
                    frames.intrinsics, prev_pose[:, None],
                    normal_pitch=frames.normal_pitch,
                )
                pose = self._localize(map_pc, live, live)
                map_pc = self._map(map_pc, live.with_poses(pose))
                prev_pose = pose[:, 0]
                poses.append(prev_pose)
                f += 1
        return map_pc, torch.stack(poses, dim=1)
