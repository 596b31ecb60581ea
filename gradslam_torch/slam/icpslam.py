r"""ICP-SLAM pipeline base (PyTorch).

Counterpart of ``gradslam_tpu/slam/icpslam.py``: ``split_prune_segments``
(:51), the constructor for the options this port supports (:336-544),
``_capacity_schedule`` (:755), ``_default_icp_capacity`` (:776),
``empty_map`` and ``_map`` (:794-811, the aggregate map),
``_icp_target_window`` (:816, with the ``icp_window_frames`` recency
window), ``_localize`` (:850, with the pyramid and its nested single
compaction) and ``_forward_impl`` (:1217): the ground-truth branch and the
tracked branch with the constant-velocity model and prune between segments,
without the relocalization and keyframe-anchor paths.

The JAX ``lax.scan`` over frames is a Python loop here. The capacity
schedule is static and host-side; nothing inside the frame or solver loops
reads a value back from the device. ``remat=True`` runs each frame's body
(the one ``jax.checkpoint`` wraps in JAX) under non-reentrant
``torch.utils.checkpoint``: its activations are dropped after the forward
and recomputed in the backward.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..geometry.geometryutils import (
    compose_transformations,
    inverse_transformation,
    orthonormalize_rotations,
)
from ..odometry.gradicp import GradICPOdometryProvider
from ..odometry.icp import ICPOdometryProvider
from ..odometry.icputils import (
    downsample_pointclouds,
    downsample_rgbdimages,
    validate_pyramid,
    validate_robust,
)
from ..odometry.projective import ProjectiveOdometryProvider
from ..structures.pointclouds import Pointclouds, compact_masked, gather_rows
from ..structures.rgbdimages import RGBDImages
from ..utils.precision import disable_tf32
from .fusionutils import find_active_map_points, prune_map, update_map_aggregate

__all__ = ["ICPSLAM", "split_prune_segments"]

# Options of the JAX pipelines that this port does not carry yet, with the
# value that means "off" and the ROADMAP.md item that will port them.
_UNPORTED = {
    "odom_point_weight": (0.0, "queue 1, item 6 (projective odometry)"),
    "odom_subpixel": (False, "queue 1, item 6 (projective odometry)"),
    "feature_channels": (0, "queue 1, item 8 (quantized colors, prune and features)"),
    "relocalize_below": (0.0, "queue 1, item 7 (recovery)"),
    "relocalize_grid": (None, "queue 1, item 7 (recovery)"),
    "relocalize_dsratio": (8, "queue 1, item 7 (recovery)"),
    "relocalize_numiters": (12, "queue 1, item 7 (recovery)"),
    "anchor_every": (0, "queue 1, item 7 (recovery)"),
    "anchor_below": (0.98, "queue 1, item 7 (recovery)"),
    "anchor_dsratio": (None, "queue 1, item 7 (recovery)"),
}


def _reject_unported(options: dict) -> None:
    for name, value in options.items():
        off, item = _UNPORTED[name]
        if value != off:
            raise NotImplementedError(
                f"{name}={value!r} is not ported to gradslam_torch yet "
                f"(ROADMAP.md {item})."
            )


def split_prune_segments(start: int, n: int, prune_every: int):
    """Split the global frame run ``[start, start + n)`` into
    ``(sub_n, prune_after)`` chunks whose boundaries land after every
    ``prune_every``-th mapped frame (global frame ``g`` with
    ``(g + 1) % prune_every == 0``), where :func:`prune_map` runs."""
    if not prune_every:
        return [(n, False)] if n else []
    out = []
    s, end, k = start, start + n, prune_every
    while s < end:
        g = s + (k - 1 - (s % k)) % k  # next boundary frame >= s
        if g < end:
            out.append((g - s + 1, True))
            s = g + 1
        else:
            out.append((end - s, False))
            s = end
    return out


class ICPSLAM(nn.Module):
    r"""Frame-to-map SLAM with an aggregate map: every valid pixel of every
    frame is appended to the map (:func:`~gradslam_torch.slam.fusionutils.
    update_map_aggregate`). :class:`~gradslam_torch.PointFusion` replaces
    the map update with point-based fusion.

    Args:
        odom: ``'gt'`` (map at the frames' poses), ``'icp'`` (frame-to-map
            ICP with the classic LM solver) or ``'gradicp'`` (with the
            differentiable gradLM solver).
        odom_assoc: ``'knn'`` (1-NN association every iteration) or
            ``'projective'`` (project the map window into the live frame);
            with a ``pyramid``, a list with one mode per level.
        odom_angle_gate: reject associations whose normals differ by more
            than this angle (degrees); None disables.
        odom_sym_normals: symmetric normals in the projective rows.
        dsratio, numiters, damp, dist_thresh: ICP solver parameters
            (``dist_thresh`` in squared metres).
        pyramid: coarse-to-fine ``[(dsratio, numiters), ...]`` replacing
            ``dsratio``/``numiters``; each level warm-starts the next.
        robust_loss, robust_scale: ``'huber'`` or ``'tukey'`` IRLS weights
            and the step guard; None is plain least squares.
        lambda_max, B, B2, nu: gradLM parameters.
        map_capacity: map buffer capacity, a fixed int (default
            ``L * H * W``) or a growth schedule ``[(frames, capacity), ...]``;
            the map is zero-padded between segments. The returned map's
            ``num_dropped`` counts rows lost to a full buffer.
        icp_capacity: capacity of the downsampled ICP target buffer
            (default ``2 * ceil(H / ds) * ceil(W / ds)`` for each level).
        icp_window_frames: if set, odometry associates against only the
            most recent ``icp_window_frames * H * W`` map rows (a recency
            window, per sequence of the batch), not the whole map.
        motion_model: ``'static'`` (each solve starts at the previous pose)
            or ``'constant_velocity'`` (at the previous pose composed with the
            previous frame's motion, re-projected onto SO(3)).
        lookahead_assoc: ``'fresh'`` or ``'reuse'`` (the lookahead error
            keeps the iteration's association).
        prune_every, prune_min_confidence: every ``prune_every``-th mapped
            frame ends with :func:`~gradslam_torch.slam.fusionutils.prune_map`
            (PointFusion only: the aggregate map has no confidences).
        normal_pitch: finite-difference baseline of the frames' normal maps
            (None keeps the frames' own).
        use_jit: accepted for the JAX constructor's signature; eager
            PyTorch has nothing to compile, so it has no effect.
        remat: recompute each frame's activations in the backward instead
            of keeping them (per-frame checkpointing, as ``jax.checkpoint``
            of the JAX scan body): the gt body is one frame's map update,
            the tracked body the prediction, localization, map update and
            constant-velocity step of one frame (frame 0's bootstrap stays
            outside). The forward's results are the same bits either way.

    The JAX pipeline's other options raise ``NotImplementedError`` unless
    left at their defaults.
    """

    has_features = False

    def __init__(
        self,
        *,
        odom: str = "gradicp",
        odom_assoc="knn",
        odom_angle_gate: Optional[float] = None,
        odom_sym_normals: bool = False,
        dsratio: int = 4,
        numiters: int = 20,
        pyramid: Optional[list] = None,
        damp: float = 1e-8,
        dist_thresh: Optional[float] = None,
        robust_loss: Optional[str] = None,
        robust_scale: float = 0.05,
        lambda_max: float = 2.0,
        B: float = 1.0,
        B2: float = 1.0,
        nu: float = 200.0,
        map_capacity=None,
        icp_capacity: Optional[int] = None,
        icp_window_frames: Optional[int] = None,
        motion_model: str = "static",
        lookahead_assoc: str = "fresh",
        prune_every: int = 0,
        prune_min_confidence: float = 1.0,
        normal_pitch: Optional[int] = None,
        use_jit: bool = True,
        remat: bool = False,
        **unported,
    ):
        super().__init__()
        unknown = set(unported) - set(_UNPORTED)
        if unknown:
            raise TypeError(f"Unknown option(s): {sorted(unknown)}.")
        _reject_unported(unported)
        if odom not in ("gt", "icp", "gradicp"):
            raise ValueError(
                f"Odometry method ({odom}) not supported. Supported: 'gt', 'icp', 'gradicp'."
            )
        if isinstance(odom_assoc, (list, tuple)):
            if pyramid is None or len(odom_assoc) != len(pyramid):
                raise ValueError(
                    "A per-level odom_assoc list requires a pyramid of the same "
                    f"length. Got {odom_assoc!r} with pyramid={pyramid!r}."
                )
            odom_assoc = tuple(odom_assoc)
            levels = odom_assoc
        else:
            levels = (odom_assoc,)
        bad = [a for a in levels if a not in ("knn", "projective")]
        if bad:
            raise ValueError(f"Unknown odom_assoc: {bad!r}. Expected 'knn' or 'projective'.")
        if odom_angle_gate is not None:
            if odom == "gt":
                raise ValueError(
                    "odom_angle_gate requires tracked odometry (odom='icp'/'gradicp'), "
                    "not odom='gt'."
                )
            if not (0 < odom_angle_gate <= 180):
                raise ValueError(
                    f"odom_angle_gate must be in (0, 180] degrees or None. Got {odom_angle_gate}."
                )
        if odom_sym_normals and "projective" not in levels:
            raise ValueError("odom_sym_normals requires odom_assoc='projective'.")
        if not isinstance(dsratio, int) or dsratio < 1:
            raise ValueError(f"dsratio must be an int >= 1. Got {dsratio}.")
        if not isinstance(numiters, int) or numiters < 1:
            raise ValueError(f"numiters must be an int >= 1. Got {numiters}.")
        if motion_model not in ("static", "constant_velocity"):
            raise ValueError(
                f"Unknown motion_model: {motion_model!r}. "
                "Expected 'static' or 'constant_velocity'."
            )
        if icp_window_frames is not None and icp_window_frames < 1:
            raise ValueError(f"icp_window_frames must be >= 1. Got {icp_window_frames}.")
        if prune_every < 0:
            raise ValueError(f"prune_every must be >= 0. Got {prune_every}.")
        if prune_every and not self.has_features:
            raise ValueError(
                "prune_every requires a pipeline whose map carries confidence "
                "counters (PointFusion); ICPSLAM's aggregate map has none."
            )
        if normal_pitch is not None and (
            not isinstance(normal_pitch, int) or normal_pitch < 1
        ):
            raise ValueError(f"normal_pitch must be None or an int >= 1. Got {normal_pitch!r}.")
        disable_tf32()
        self.odom = odom
        self.dsratio = dsratio
        self.map_capacity = map_capacity
        self.icp_capacity = icp_capacity
        self.icp_window_frames = icp_window_frames
        self.motion_model = motion_model
        self.prune_every = int(prune_every)
        self.prune_min_confidence = prune_min_confidence
        self.normal_pitch = normal_pitch
        self.remat = bool(remat)
        self.pyramid = validate_pyramid(pyramid)
        validate_robust(robust_loss, robust_scale)
        dot_gate = None if odom_angle_gate is None else math.cos(math.radians(odom_angle_gate))

        def make_provider(n_iters, assoc):
            if odom == "gt":
                return None
            if assoc == "projective":
                return ProjectiveOdometryProvider(
                    solver=odom, numiters=n_iters, damp=damp, dist_thresh=dist_thresh,
                    dot_gate=dot_gate, lambda_max=lambda_max, B=B, B2=B2, nu=nu,
                    lookahead_assoc=lookahead_assoc, robust_loss=robust_loss,
                    robust_scale=robust_scale, sym_normals=odom_sym_normals,
                )
            if odom == "icp":
                return ICPOdometryProvider(
                    n_iters, damp, dist_thresh, lookahead_assoc, robust_loss, robust_scale,
                    dot_gate=dot_gate,
                )
            return GradICPOdometryProvider(
                n_iters, damp, dist_thresh, lambda_max, B, B2, nu,
                lookahead_assoc, robust_loss, robust_scale, dot_gate=dot_gate,
            )

        if self.pyramid is None:
            self.odomprov = make_provider(numiters, odom_assoc)
            self._pyramid_provs = None
        else:
            assocs = odom_assoc if isinstance(odom_assoc, tuple) else (odom_assoc,) * len(
                self.pyramid)
            self._pyramid_provs = [
                make_provider(n, a) for (_, n), a in zip(self.pyramid, assocs)
            ]
            self.odomprov = self._pyramid_provs[-1]  # finest level

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

    def _default_icp_capacity(self, H: int, W: int, ds: Optional[int] = None) -> int:
        if self.icp_capacity is not None:
            return self.icp_capacity
        ds = self.dsratio if ds is None else ds
        return 2 * math.ceil(H / ds) * math.ceil(W / ds)

    def empty_map(
        self, batch_size: int, capacity: int, *, device="cuda", dtype=torch.float32
    ) -> Pointclouds:
        r"""An empty map buffer for this pipeline on ``device`` (the card
        by default): the
        aggregate map carries normals and float colors, no features."""
        return Pointclouds.empty(
            batch_size, capacity, device=device, dtype=dtype,
            has_normals=True, has_colors=True, feature_dim=None,
        )

    def _map(self, pointclouds: Pointclouds, live_frame: RGBDImages) -> Pointclouds:
        return update_map_aggregate(pointclouds, live_frame)

    def _prune(self, pointclouds: Pointclouds) -> Pointclouds:
        return prune_map(pointclouds, self.prune_min_confidence)

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
    def _icp_target_window(self, pointclouds: Pointclouds, H: int, W: int) -> Pointclouds:
        """Geometry-only view of the map (the solvers read no colors or
        features), cut to the ``icp_window_frames`` recency window when it
        is set: for each sequence the ``rows`` map rows starting at
        ``clip(num_points - rows, 0, cap - rows)``, gathered on the device
        (the start differs per sequence and stays there)."""
        rows = None if self.icp_window_frames is None else self.icp_window_frames * H * W
        cap = pointclouds.capacity
        if rows is None or rows >= cap:
            return Pointclouds(
                points=pointclouds.points,
                num_points=pointclouds.num_points,
                normals=pointclouds.normals,
            )
        start = torch.clamp(pointclouds.num_points - rows, min=0, max=cap - rows)
        idx = start[:, None] + torch.arange(rows, device=start.device)[None, :]
        return Pointclouds(
            points=gather_rows(pointclouds.points, idx),
            num_points=torch.clamp(pointclouds.num_points, max=rows),
            normals=gather_rows(pointclouds.normals, idx),
        )

    def _localize(
        self, pointclouds: Pointclouds, live_frame: RGBDImages, prev_frame: RGBDImages
    ) -> torch.Tensor:
        r"""Align the live frame against the downsampled active map, level by
        level; returns poses ``(B, 1, 4, 4)``."""
        _, _, H, W = live_frame.shape
        live_frame = live_frame.with_poses(prev_frame.poses)
        target = self._icp_target_window(pointclouds, H, W)
        active = find_active_map_points(target, prev_frame)

        def solve_with(prov, maps_pc, ds, init_T):
            if isinstance(prov, ProjectiveOdometryProvider):
                # the live frame's own vertex and normal images are the target
                return prov.provide(maps_pc, live_frame, initial_transform=init_T)
            frames_pc = downsample_rgbdimages(live_frame, ds)
            return prov.provide(maps_pc, frames_pc, initial_transform=init_T)

        def window(ds):
            return downsample_pointclouds(
                target, active.valid, active.pix_h, active.pix_w, ds,
                self._default_icp_capacity(H, W, ds),
            )

        if self.pyramid is None:
            transform = solve_with(self.odomprov, window(self.dsratio), self.dsratio, None)
        else:
            ds_fine = self.pyramid[-1][0]
            nested = len(self.pyramid) > 1 and all(ds % ds_fine == 0 for ds, _ in self.pyramid)
            transform = None
            if nested:
                # Compact the full map once at the finest stride, the pixel
                # coordinates riding along as two float channels, and carve
                # the coarser windows out of that small buffer (every coarser
                # stride is a multiple of the finest one).
                capf = self._default_icp_capacity(H, W, ds_fine)
                dt = target.points.dtype
                packed = torch.cat([
                    target.points, target.normals,
                    active.pix_h[..., None].to(dt), active.pix_w[..., None].to(dt),
                ], dim=-1)
                keep = (active.valid & (active.pix_h % ds_fine == 0)
                        & (active.pix_w % ds_fine == 0))
                win8, counts = compact_masked(packed, keep, capf)
                dropped_f = keep.sum(dim=-1) - counts
                rowmask = torch.arange(capf, device=counts.device)[None] < counts[:, None]
                for prov, (ds_l, _n) in zip(self._pyramid_provs, self.pyramid):
                    init_T = None if transform is None else transform[:, 0]
                    if ds_l == ds_fine:
                        maps_pc = Pointclouds(
                            points=win8[..., :3], num_points=counts,
                            normals=win8[..., 3:6], num_dropped=dropped_f,
                        )
                    else:
                        ph = win8[..., 6].to(torch.int64)
                        pw = win8[..., 7].to(torch.int64)
                        keep_l = rowmask & (ph % ds_l == 0) & (pw % ds_l == 0)
                        sub, c_l = compact_masked(
                            win8[..., :6], keep_l, self._default_icp_capacity(H, W, ds_l))
                        maps_pc = Pointclouds(
                            points=sub[..., :3], num_points=c_l, normals=sub[..., 3:6],
                            num_dropped=dropped_f + keep_l.sum(dim=-1) - c_l,
                        )
                    transform = solve_with(prov, maps_pc, ds_l, init_T)
            else:
                for prov, (ds, _n) in zip(self._pyramid_provs, self.pyramid):
                    init_T = None if transform is None else transform[:, 0]
                    transform = solve_with(prov, window(ds), ds, init_T)
        return compose_transformations(transform[:, 0], prev_frame.poses[:, 0])[:, None]

    # ------------------------------------------------------------------ #
    # Forward
    # ------------------------------------------------------------------ #
    def _frame(self, body, *args):
        """One frame's ``body(*args)``, under per-frame checkpointing when
        ``remat`` is set. Non-reentrant: the body takes and returns
        dataclasses of tensors, whose gradients the reentrant form would
        drop. The body draws no random numbers, so no RNG state is kept."""
        if not self.remat:
            return body(*args)
        return checkpoint(body, *args, use_reentrant=False, preserve_rng_state=False)

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
            start = 0
            for n, cap_seg in schedule:
                map_pc = map_pc.with_capacity(cap_seg)
                for sub_n, prune_after in split_prune_segments(start, n, self.prune_every):
                    for i in range(start, start + sub_n):
                        map_pc = self._frame(self._map, map_pc, frames[:, i])
                    if prune_after:
                        map_pc = self._prune(map_pc)
                    start += sub_n
            return map_pc, frames.poses

        # Tracked: bootstrap frame 0 at the provided (or identity) pose,
        # then track frame to map, each solve starting at the prediction.
        if frames.poses is not None:
            prev_pose = frames.poses[:, 0]
        else:
            prev_pose = torch.eye(4, dtype=frames.dtype, device=frames.device).expand(B, 4, 4)
        poses = [prev_pose]
        map_pc = self._map(map_pc, frames[:, 0].with_poses(prev_pose[:, None]))
        if self.prune_every == 1:  # (0 + 1) % prune_every == 0 only then
            map_pc = self._prune(map_pc)
        cv = self.motion_model == "constant_velocity"

        def track(map_pc, prev_pose, prev_delta, rgb, depth):
            # the constant-velocity chain pose @ inv(prev) @ pose doubles the
            # rotation's orthonormality error each frame: re-project
            pred = (orthonormalize_rotations(compose_transformations(prev_delta, prev_pose))
                    if cv else prev_pose)
            live = RGBDImages(rgb, depth, frames.intrinsics, pred[:, None],
                              normal_pitch=frames.normal_pitch)
            pose = self._localize(map_pc, live, live)[:, 0]
            map_pc = self._map(map_pc, live.with_poses(pose[:, None]))
            if cv:  # world-frame motion of this frame, the next prediction
                prev_delta = compose_transformations(pose, inverse_transformation(prev_pose))
            return map_pc, pose, prev_delta

        prev_delta = torch.eye(4, dtype=frames.dtype, device=frames.device).expand(B, 4, 4)
        start = 0  # tracked frames done; global frame = start + 1
        for i, (n, cap_seg) in enumerate(schedule):
            n_track = n - 1 if i == 0 else n  # frame 0 was mapped above
            map_pc = map_pc.with_capacity(cap_seg)
            for sub_n, prune_after in split_prune_segments(start + 1, n_track, self.prune_every):
                for f in range(start + 1, start + 1 + sub_n):
                    map_pc, prev_pose, prev_delta = self._frame(
                        track, map_pc, prev_pose, prev_delta,
                        frames.rgb_image[:, f:f + 1], frames.depth_image[:, f:f + 1])
                    poses.append(prev_pose)
                if prune_after:
                    map_pc = self._prune(map_pc)
                start += sub_n
        return map_pc, torch.stack(poses, dim=1)
