r"""ICP-SLAM pipeline base (PyTorch).

Counterpart of ``gradslam_tpu/slam/icpslam.py``: ``split_prune_segments``
(:51), the constructor for the options this port supports (:336-544),
``_capacity_schedule`` (:755), ``_default_icp_capacity`` (:776),
``empty_map`` and ``_map`` (:794-811, the aggregate map),
``_icp_target_window`` (:816, with the ``icp_window_frames`` recency
window), ``_localize`` (:850, with the pyramid and its nested single
compaction, and the finest window it solved against), the in-scan recovery
(``_health_gate`` :992, ``_maybe_relocalize`` :1023, ``_anchor_snapshot``
:1087, ``_maybe_anchor_recover`` :1107, each ``_maybe_*`` as a gate half in
the frame's gate body and a branch half) and ``_forward_impl`` (:1217): the
ground-truth branch and the tracked branch with the constant-velocity
model, prune between segments, relocalization and the keyframe anchor; and
the online API (``step``, ``localize``, ``map_update``; :594-742,
``_step_impl`` :1209), one frame at a time through the forward's own
per-frame body.

The JAX ``lax.scan`` over frames is a Python loop here. The capacity
schedule is static and host-side. An unarmed pipeline reads nothing back
from the device inside the frame or solver loops, so with ``use_jit`` (the
default, as in JAX) its frame body runs on the card as a CUDA graph,
captured once for each capacity segment and replayed for each frame
(:mod:`gradslam_torch.utils.graphs`), as ``jax.jit`` compiles the scan body
once. Armed (``relocalize_below > 0``) and captured, a tracked frame is one
graph too (:meth:`ICPSLAM._armed`), whose recovery branches are CUDA graph
conditional nodes decided on the device, as the JAX body decides its three
``lax.cond``\ s: the gate (prediction, localization, the health gate and,
with ``anchor_every``, the drift gate), the relocalization (with the
anchor, the drift gate on the pose it leaves), the anchor re-solve, and
the fuse (map update, motion, the anchor's refresh in a conditional of its
own); the run reads the branch frames back once, after its last frame.
Under autograd the frame is one ``FrameGraphs.grad`` call, whose
branches' VJPs are conditional nodes on the same predicates (as
``jax.grad`` through ``lax.cond``), read once more after the backward's
last frame: with ``remat`` the forward replays that graph and the backward
a graph of its recompute and VJP; without, the forward is captured with
its residuals kept, each branch's only on the frames where it ran, and the
backward graph reads them. Eagerly the frame is split where the JAX body
has its ``lax.cond``\ s: a gate body, one read back of its flags to the
host, the recovery branches as Python ``if``\ s, each a body of its own run
only on the frames that need it (a second read after a relocalization with
the anchor), and a fuse body (:meth:`ICPSLAM._track`); which of the two is
a pure function of whether the call is captured: :func:`armed_on_device`.
``remat=True`` runs each frame's bodies (the one ``jax.checkpoint`` wraps
in JAX) under non-reentrant ``torch.utils.checkpoint``: their activations
are dropped after the forward and recomputed in the backward. Under
autograd ``forward`` replays each frame's forward and backward from CUDA
graphs as well, with or without ``remat`` (``FrameGraphs.grad``), as JAX jits
``value_and_grad`` through the scan; the gradient of a frame with a branch
flows through the branch that ran, as ``jax.grad`` through ``lax.cond``.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import warnings
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
from ..odometry.projective import ProjectiveOdometryProvider, pack_frame_geom
from ..structures.pointclouds import Pointclouds, compact_masked, gather_rows
from ..structures.rgbdimages import RGBDImages
from ..utils.graphs import (
    FrameGraphs,
    clone_tree,
    eager_reason_for,
    flatten,
    needs_grad,
    unflatten,
    when,
)
from ..utils.precision import disable_tf32
from .fusionutils import find_active_map_points, prune_map, update_map_aggregate
from .health import (
    _association_health,
    _projective_health,
    _window_health_knn,
    _window_health_projective,
)
from .relocalize import _compose_grid, _grid_deltas, relocalize

__all__ = ["ICPSLAM", "split_prune_segments"]


def _check_prev_transform(prev_transform, live_frame: RGBDImages) -> None:
    B = live_frame.shape[0]
    if prev_transform is not None and tuple(prev_transform.shape) != (B, 4, 4):
        # the natural mistake, the (B, 1, 4, 4) pose step returns, would
        # broadcast into rank-5 poses and fail far downstream
        raise ValueError(
            f"prev_transform must have shape (B, 4, 4) = ({B}, 4, 4). "
            f"Got {tuple(prev_transform.shape)}."
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


def _through_views(args: tuple) -> tuple:
    """``args`` with each tensor that requires a gradient taken through one
    view (``view_as``): the gradients of its uses inside an eager call then
    sum at that view before the caller's uses' are added, in the order a
    captured call's backward sums them, so that both give the same bits."""
    leaves, spec = flatten(args)
    return unflatten(spec, [t.view_as(t) if t.requires_grad else t for t in leaves])


def _read_back(flags: torch.Tensor) -> list:
    """The host's read of an armed frame's gate flags (any unhealthy; with
    the anchor, any and all drifting), or, captured, of every frame's
    branch predicates at once: the one place a tracked ``forward`` waits
    for the device, once a frame where no branch runs when the host
    decides, once a run when the device does (and, under autograd, once
    more after the backward's last frame; once more again in the forward
    that grows a conditional body's store: ``FrameGraphs.settle``)."""
    return flags.tolist()


def armed_on_device(captured: bool, grad: bool, remat: bool) -> bool:
    r"""Whether an armed ``forward`` decides its recovery branches on the
    device, one graph a tracked frame (:meth:`ICPSLAM._armed`): whenever it
    is captured, without autograd and under it with or without ``remat``
    (without, each branch's residuals kept only on the frames where it
    ran: ``FrameGraphs.grad``). Eagerly the host decides. A pure function
    of these facts, never a reaction to a failure."""
    return captured


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
        feature_channels: user feature channels a map point carries, from
            the frames' ``feature_image`` (semantic one-hots, descriptors):
            the aggregate map appends them after each point's confidence
            (``[alpha, *user]``), PointFusion fuses them like colors. The
            frames must carry exactly this many.
        normal_pitch: finite-difference baseline of the frames' normal maps
            (None keeps the frames' own).
        use_jit: run each frame's body as a CUDA graph, the counterpart of
            the JAX package's jitted scan body: ``forward``'s frame body
            (the map update for ``odom='gt'``, the tracked frame otherwise:
            prediction, localization, map update and motion), ``step``,
            ``localize`` and ``map_update`` are captured once for each key
            (the path, its options, and the shapes, dtypes and device of its
            inputs: one graph for each capacity segment) in
            ``frame_graphs`` (:class:`~gradslam_torch.utils.graphs.
            FrameGraphs`) and replayed for every later frame; frame 0's
            bootstrap, the prune between segments and ``step``'s one read
            back of the map count stay eager. A replay gives the eager bits,
            and the kernels' launch counters read the same.

            Under autograd (grad mode with an input that requires grad)
            ``forward`` replays each frame's forward and backward too, as
            JAX jits ``value_and_grad`` through its scan: each frame is one
            autograd node whose backward replays a captured backward, one
            for each key (which inputs need a gradient is part of it) and
            set of outputs that get a gradient; see ``remat`` for what each
            frame keeps. Every call after the first replays, so a training
            loop that keeps its pipeline (``refine()`` in
            :mod:`gradslam_torch.examples.gradient_refinement`) replays its
            steady steps; the gradients are the eager bits. The autograd
            nodes of frame 0's bootstrap and of the prunes, which stay
            eager, link to the replayed frames', and a tensor every frame
            shares (the intrinsics) sums its frames' gradients in autograd.
            ``step``, ``localize`` and ``map_update`` under autograd replay
            their forward and backward graphs the same way, each call one
            autograd node of its own, as JAX jits them under ``jax.grad``.

            Armed recovery (``relocalize_below > 0``) is captured too:
            without gradients each tracked frame replays one graph whose
            recovery branches are conditional nodes decided on the device,
            and the run reads the branch frames back once, at its end;
            under autograd each tracked frame replays a forward and a
            backward graph, the branches' VJPs conditional nodes too, and
            the backward reads once more, after its last frame (with
            ``remat`` the forward is that graph and the backward its
            recompute and VJP; without, see ``remat``).

            After each call ``last_call_captured`` says whether it ran so
            and ``last_eager_reason`` why not. Calls with ``use_jit=False``
            and calls on CPU tensors (there is no graph to capture) run
            eagerly. A capture that fails raises; nothing falls back to
            eager.
        remat: recompute each frame's activations in the backward instead
            of keeping them (per-frame checkpointing, as ``jax.checkpoint``
            of the JAX scan body): the gt body is one frame's map update,
            the tracked body the prediction, localization, map update and
            constant-velocity step of one frame (frame 0's bootstrap stays
            outside). The forward's results are the same bits either way.
            Eagerly each body runs under non-reentrant
            ``torch.utils.checkpoint``; captured, the forward replays the
            no-grad frame graph and each frame keeps only its inputs, and
            the backward replays a graph of the recompute and its
            backward. Without ``remat`` a captured frame keeps, in one
            copy, the storages of every tensor autograd saved (what eager
            keeps), and its backward graph reads them back; an armed
            frame's recovery branches keep theirs only on the frames where
            they ran, in a store each that the first gradient step sizes
            (that step's forward runs twice: ``FrameGraphs.settle``), and
            again a step whose branches run on more frames, or a second
            forward before the first one's backward.
        odom_point_weight: point-to-point rows at this weight beside the
            projective solver's plane rows (0 disables).
        odom_subpixel: bilinear projective association at the continuous
            projected pixel instead of the nearest pixel.
        relocalize_below: arm the tracking recovery (0 disables): after
            each solve the inlier fraction of the solve's own finest window
            at the solved pose is read, and where it is below this value a
            multi-hypothesis :func:`~gradslam_torch.slam.relocalize.
            relocalize` runs from a :func:`~gradslam_torch.slam.relocalize.
            perturbation_grid` around the solved pose; its pose is taken
            only where it scores strictly better. Tracked odometry only.
            Captured, with or without gradients, the branches are
            decided on the device inside the frame's graphs, as the JAX
            package decides its ``lax.cond``; eagerly the host reads the
            gates' flags once a frame, and each branch is a body of its
            own, run on the frames that need it, where the anchor's gate
            is read once more after a relocalization.
        relocalize_grid: the grid's ``yaw_deg`` and ``translations``.
        relocalize_dsratio, relocalize_numiters: the recovery solves'
            stride and iterations.
        anchor_every: with ``relocalize_below``, also carry a frozen
            keyframe anchor (seeded from frame 0, refreshed every
            ``anchor_every`` frames unless drifting) and score each solved
            pose against it; where the conditional inlier fraction falls
            below ``anchor_below`` while the anchor is in view, re-solve
            against the anchor (Tukey 1-NN at twice ``robust_scale``) and
            take that pose only where it scores better. 0 disables.
        anchor_below: the drift gate's threshold.
        anchor_dsratio: the anchor snapshot's stride (default ``dsratio``).

    After a tracked ``forward``, ``recovery_log`` holds the armed gate's
    reading of each tracked frame (``'health'``, ``(B,)`` tensors) and the
    global frame indices on which the relocalization (``'relocalize'``) or
    the anchor re-solve (``'anchor'``) ran.
    """

    has_features = False

    def __init__(
        self,
        *,
        odom: str = "gradicp",
        odom_assoc="knn",
        odom_angle_gate: Optional[float] = None,
        odom_sym_normals: bool = False,
        odom_point_weight: float = 0.0,
        odom_subpixel: bool = False,
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
        feature_channels: int = 0,
        normal_pitch: Optional[int] = None,
        relocalize_below: float = 0.0,
        relocalize_grid: Optional[dict] = None,
        relocalize_dsratio: int = 8,
        relocalize_numiters: int = 12,
        anchor_every: int = 0,
        anchor_below: float = 0.98,
        anchor_dsratio: Optional[int] = None,
        use_jit: bool = True,
        remat: bool = False,
    ):
        super().__init__()
        # The checks and their messages follow the JAX constructor
        # (gradslam_tpu/slam/icpslam.py:336-544), in its order.
        if odom not in ("gt", "icp", "gradicp"):
            raise ValueError(
                f"Odometry method ({odom}) not supported for ICPSLAM. Currently supported "
                "odometry modules for ICPSLAM are: 'gt', 'icp', 'gradicp'"
            )
        if isinstance(odom_assoc, (list, tuple)):
            if pyramid is None or len(odom_assoc) != len(pyramid):
                raise ValueError(
                    "A per-level odom_assoc list requires a pyramid of the same "
                    f"length. Got {odom_assoc!r} with pyramid={pyramid!r}."
                )
            odom_assoc = tuple(odom_assoc)
            levels = odom_assoc
            bad = [a for a in levels if a not in ("knn", "projective")]
            if bad:
                raise ValueError(
                    f"Unknown odom_assoc level(s): {bad!r}. Expected 'knn' or 'projective'.")
        else:
            levels = (odom_assoc,)
            if odom_assoc not in ("knn", "projective"):
                raise ValueError(
                    f"Unknown odom_assoc: {odom_assoc!r}. Expected 'knn' or 'projective'.")
        any_projective = "projective" in levels
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
        if (odom_sym_normals or odom_point_weight) and not any_projective:
            raise ValueError(
                "odom_sym_normals / odom_point_weight require odom_assoc='projective' "
                "(they shape the projective solver's rows; the KNN mode has no "
                "per-association frame normal)."
            )
        if odom_point_weight < 0:
            raise ValueError(f"odom_point_weight must be >= 0. Got {odom_point_weight}.")
        if odom_subpixel and not any_projective:
            raise ValueError(
                "odom_subpixel requires odom_assoc='projective' (it refines the projective "
                "association's pixel lookup; the KNN mode has no pixel grid)."
            )
        if not isinstance(dsratio, int) or dsratio < 1:
            raise ValueError(f"dsratio must be an int >= 1. Got {dsratio}.")
        if not isinstance(numiters, int) or numiters < 1:
            raise ValueError(f"numiters must be an int >= 1. Got {numiters}.")
        if icp_window_frames is not None and icp_window_frames < 1:
            raise ValueError(f"icp_window_frames must be >= 1. Got {icp_window_frames}.")
        if motion_model not in ("static", "constant_velocity"):
            raise ValueError(
                f"Unknown motion_model: {motion_model!r}. "
                "Expected 'static' or 'constant_velocity'."
            )
        if prune_every < 0:
            raise ValueError(f"prune_every must be >= 0. Got {prune_every}.")
        if prune_every and not self.has_features:
            raise ValueError(
                "prune_every requires a pipeline whose map carries confidence "
                "counters (PointFusion); ICPSLAM's aggregate map has none."
            )
        if not isinstance(feature_channels, int) or feature_channels < 0:
            raise ValueError(
                f"feature_channels must be a non-negative int. Got {feature_channels!r}."
            )
        if normal_pitch is not None and (
            not isinstance(normal_pitch, int) or normal_pitch < 1
        ):
            raise ValueError(f"normal_pitch must be None or an int >= 1. Got {normal_pitch!r}.")
        if relocalize_below < 0 or relocalize_below >= 1:
            raise ValueError(
                f"relocalize_below must be in [0, 1) (0 disables). Got {relocalize_below}."
            )
        if relocalize_below > 0 and odom == "gt":
            raise ValueError(
                "relocalize_below requires tracked odometry (odom='icp'/'gradicp'), not "
                "odom='gt' — ground-truth poses cannot be lost."
            )
        if relocalize_dsratio < 1 or relocalize_numiters < 1:
            raise ValueError(
                "relocalize_dsratio and relocalize_numiters must be >= 1. "
                f"Got {relocalize_dsratio}, {relocalize_numiters}."
            )
        if anchor_every < 0 or not isinstance(anchor_every, int):
            raise ValueError(f"anchor_every must be a non-negative int. Got {anchor_every!r}.")
        if anchor_every > 0 and not (relocalize_below > 0):
            raise ValueError(
                "anchor_every requires relocalize_below > 0 — the anchored drift gate "
                "reuses the in-scan relocalization threshold and recovery machinery."
            )
        if not (0 < anchor_below <= 1):
            raise ValueError(f"anchor_below must be in (0, 1]. Got {anchor_below}.")
        if anchor_dsratio is not None and (
            not isinstance(anchor_dsratio, int) or anchor_dsratio < 1
        ):
            raise ValueError(f"anchor_dsratio must be None or an int >= 1. Got {anchor_dsratio!r}.")
        self.pyramid = validate_pyramid(pyramid)
        validate_robust(robust_loss, robust_scale)
        disable_tf32()
        self.odom = odom
        self.dsratio = dsratio
        self.dist_thresh = dist_thresh
        self.robust_scale = robust_scale
        self.map_capacity = map_capacity
        self.icp_capacity = icp_capacity
        self.icp_window_frames = icp_window_frames
        self.motion_model = motion_model
        self.prune_every = int(prune_every)
        self.prune_min_confidence = prune_min_confidence
        self.feature_channels = feature_channels
        self.normal_pitch = normal_pitch
        self.remat = bool(remat)
        self.use_jit = bool(use_jit)
        self.frame_graphs = FrameGraphs()
        self.last_call_captured = False
        self.last_eager_reason = None
        # the finest level's association decides the health statistic's
        self._finest_assoc = levels[-1]
        self.relocalize_below = float(relocalize_below)
        self.relocalize_grid = dict(relocalize_grid or {})
        self.relocalize_dsratio = relocalize_dsratio
        self.relocalize_numiters = relocalize_numiters
        self.anchor_every = int(anchor_every)
        self.anchor_below = float(anchor_below)
        self.anchor_dsratio = anchor_dsratio
        self.recovery_log = {"health": [], "relocalize": [], "anchor": []}
        self._deltas = {}  # (dtype, device) -> the relocalization grid's deltas
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
                    point_weight=odom_point_weight, subpixel=odom_subpixel,
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

    _map_has_colors = True

    @property
    def _map_feature_dim(self) -> Optional[int]:
        """The aggregate map's features: ``[alpha, *user]`` with user
        channels, none without."""
        return 1 + self.feature_channels if self.feature_channels else None

    def empty_map(
        self, batch_size: int, capacity: int, *, device="cuda", dtype=torch.float32
    ) -> Pointclouds:
        r"""An empty map buffer for this pipeline on ``device`` (the card by
        default), the initial value of the online :meth:`step`: the
        aggregate map carries normals and float colors, and features only
        with user channels (``[alpha, *user]``); PointFusion's map carries
        ``[ccount, *user]`` beside float colors, or ``[ccount,
        packed_color, *user]`` and no colors when quantized."""
        return Pointclouds.empty(
            batch_size, capacity, device=device, dtype=dtype, has_normals=True,
            has_colors=self._map_has_colors, feature_dim=self._map_feature_dim,
        )

    def _map(self, pointclouds: Pointclouds, live_frame: RGBDImages) -> Pointclouds:
        return update_map_aggregate(pointclouds, live_frame)

    def _prune(self, pointclouds: Pointclouds) -> Pointclouds:
        return prune_map(pointclouds, self.prune_min_confidence)

    def _with_normal_pitch(self, frames: RGBDImages) -> RGBDImages:
        if self.normal_pitch is None or frames.normal_pitch == self.normal_pitch:
            return frames
        return dataclasses.replace(frames, normal_pitch=self.normal_pitch)

    def _check_features(self, frames: RGBDImages, subject: str) -> None:
        """The frames' feature plane must be as wide as the map's user
        channels: a plane the map cannot hold would otherwise be dropped,
        or the fusion would fail mid-run on the widths. ``subject`` names
        the frames in the message (``"frames carry"``)."""
        want, got = self.feature_channels, frames.feature_channels
        if want != got:
            hint = (f"construct the pipeline with feature_channels={got}" if got
                    else f"attach RGBDImages.feature_image with {want} channel(s)")
            raise ValueError(
                f"{subject} {got} feature channel(s) but this pipeline fuses {want}: {hint}."
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
        self, pointclouds: Pointclouds, live_frame: RGBDImages, prev_frame: RGBDImages,
        return_window: bool = False,
    ):
        r"""Align the live frame against the downsampled active map, level by
        level; returns poses ``(B, 1, 4, 4)``, and with ``return_window``
        also the finest level's compacted map window (points and normals),
        which the recovery gate scores the solved pose against."""
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
            maps_pc = window(self.dsratio)
            transform = solve_with(self.odomprov, maps_pc, self.dsratio, None)
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
                    maps_pc = window(ds)
                    transform = solve_with(prov, maps_pc, ds, init_T)
        poses = compose_transformations(transform[:, 0], prev_frame.poses[:, 0])[:, None]
        if return_window:  # the last level solved is the finest
            return poses, Pointclouds(points=maps_pc.points, num_points=maps_pc.num_points,
                                      normals=maps_pc.normals)
        return poses

    # ------------------------------------------------------------------ #
    # Tracking recovery
    # ------------------------------------------------------------------ #
    def _health_gate(self, live: RGBDImages, poses: torch.Tensor,
                     window: Pointclouds) -> torch.Tensor:
        """The armed gate's inlier fraction ``(B,)``: the solved pose scored
        against the solve's own finest window (no pass over the map): the
        projective association, or one 1-NN launch."""
        if self._finest_assoc == "projective":
            _, _, H, W = live.shape
            inlier, _assoc = _window_health_projective(
                window, pack_frame_geom(live), live.intrinsics[:, 0], poses[:, 0], H, W,
                robust_scale=self.robust_scale, dist_thresh=self.dist_thresh)
            return inlier
        ds = self.pyramid[-1][0] if self.pyramid else self.dsratio
        frames_pc = downsample_rgbdimages(live.with_poses(poses), ds)
        return _window_health_knn(frames_pc, window, robust_scale=self.robust_scale,
                                  dist_thresh=self.dist_thresh)

    def _grid_deltas(self, pose: torch.Tensor) -> torch.Tensor:
        """The relocalization grid's deltas ``(K, 4, 4)`` on ``pose``'s
        dtype and device, made once (a copy from the host, which no capture
        may hold) and then an input of the branch body."""
        key = (pose.dtype, pose.device)
        if key not in self._deltas:
            self._deltas[key] = _grid_deltas(pose.dtype, pose.device, **self.relocalize_grid)
        return self._deltas[key]

    def _relocalize(self, map_pc: Pointclouds, live: RGBDImages, poses: torch.Tensor,
                    inlier: torch.Tensor, deltas: torch.Tensor, anchor=None):
        """The relocalization branch, run where any sequence's gate reading
        ``inlier`` (:meth:`_health_gate`, the gate half) is below
        ``relocalize_below``. Returns ``(poses, taken)``, ``taken`` the
        sequences ``(B,)`` that took the recovered pose; given an
        ``anchor``, then the drift gate's ``(inliers, drifting, flags)`` on
        the pose it leaves (:meth:`_anchor_gate`; ``flags`` any and all
        drifting, what the host reads next), as the JAX body runs
        ``_maybe_anchor_recover`` on the pose ``_maybe_relocalize`` returns.
        Relocalize from the grid ``deltas`` (:meth:`_grid_deltas`) around
        the solved pose (the hypotheses one after another, as the JAX
        in-scan branch does, and without the tracking ``dist_thresh``,
        which would starve the far-off starts) and take the recovered pose
        of each unhealthy sequence where it scores strictly better than the
        failed solve, both scored by the full health at the pipeline's
        ``dsratio``. ``live``'s poses are not read."""
        unhealthy = inlier < self.relocalize_below
        target = Pointclouds(points=map_pc.points, num_points=map_pc.num_points,
                             normals=map_pc.normals)
        health = (_projective_health if self._finest_assoc == "projective"
                  else _association_health)
        kw = dict(dsratio=self.dsratio, robust_scale=self.robust_scale,
                  dist_thresh=self.dist_thresh, icp_capacity=None)
        h1 = health(target, live.with_poses(poses), **kw)
        rec, _info = relocalize(
            target, live, _compose_grid(poses[:, 0], deltas), odom=self.odom,
            dsratio=self.relocalize_dsratio, numiters=self.relocalize_numiters,
            robust_scale=self.robust_scale, hypothesis_mode="scan")
        h2 = health(target, live.with_poses(rec), **kw)
        take = unhealthy & (h2["inlier_frac"] > h1["inlier_frac"])
        poses = torch.where(take[:, None, None, None], rec, poses)
        if anchor is None:
            return poses, take
        inl, drifting = self._anchor_gate(anchor, live, poses)
        return poses, take, inl, drifting, torch.stack([drifting.any(), drifting.all()])

    def _anchor_snapshot(self, live: RGBDImages) -> Tuple[torch.Tensor, ...]:
        """The frozen keyframe ``(points, normals, counts)``: the frame's
        stride-``anchor_dsratio`` world-frame cloud at its pose, zero-normal
        rows dropped. A strided anchor is safe here: the drift gate
        associates by projection, with no stride filter on the map side."""
        pc = downsample_rgbdimages(live, self.anchor_dsratio or self.dsratio)
        solid = pc.nonpad_mask & (torch.sum(pc.normals * pc.normals, dim=-1) > 0.0)
        cap = pc.points.shape[1]
        pts, cnt = compact_masked(pc.points, solid, cap)
        nrm, _ = compact_masked(pc.normals, solid, cap)
        return pts, nrm, cnt

    def _anchor_health(self, anchor: Tuple[torch.Tensor, ...], live: RGBDImages,
                       pose: torch.Tensor):
        """``pose (B, 4, 4)`` scored against the anchor by projection:
        ``(inliers, conditional inlier fraction, admissible fraction)``."""
        a_pts, a_nrm, a_cnt = anchor
        _, _, H, W = live.shape
        inl, assoc = _window_health_projective(
            Pointclouds(points=a_pts, num_points=a_cnt, normals=a_nrm), pack_frame_geom(live),
            live.intrinsics[:, 0], pose, H, W, robust_scale=self.robust_scale,
            dist_thresh=self.dist_thresh)
        return inl, inl / torch.clamp(assoc, min=1e-6), assoc

    def _anchor_gate(self, anchor: Tuple[torch.Tensor, ...], live: RGBDImages,
                     poses: torch.Tensor):
        """The drift gate, the anchor's gate half: ``(inliers, drifting)``
        of the solved pose, ``drifting (B,)`` where the anchor is in view
        (admissible fraction above 0.2) and the conditional inlier fraction
        (inliers among admissible rows, which the camera's own motion leaves
        alone) is below ``anchor_below``."""
        inl, cond, assoc = self._anchor_health(anchor, live, poses[:, 0])
        return inl, (assoc > 0.2) & (cond < self.anchor_below)

    def _anchor_resolve(self, anchor: Tuple[torch.Tensor, ...], live: RGBDImages,
                        poses: torch.Tensor, inl: torch.Tensor, drifting: torch.Tensor):
        """The drift branch, run where any sequence drifts
        (:meth:`_anchor_gate`): one Tukey 1-NN solve against the anchor from
        the solved pose at ``2 * robust_scale``, its pose taken where its
        absolute inlier fraction is higher than the gate's ``inl``. Returns
        ``(poses, taken, drifting)``: ``drifting`` as it came, so that the
        fuse body reads it from this body's static input when captured (an
        output of the relocalization's graph may lie in this graph's
        scratch)."""
        a_pts, a_nrm, a_cnt = anchor
        frames_pc = downsample_rgbdimages(live.with_poses(poses), self.dsratio)
        prov_cls = GradICPOdometryProvider if self.odom == "gradicp" else ICPOdometryProvider
        prov = prov_cls(numiters=self.relocalize_numiters, robust_loss="tukey",
                        robust_scale=2.0 * self.robust_scale)
        X = prov.provide(Pointclouds(points=a_pts, num_points=a_cnt, normals=a_nrm), frames_pc)
        rec = orthonormalize_rotations(compose_transformations(X[:, 0], poses[:, 0]))[:, None]
        in2, _cond2, _assoc2 = self._anchor_health(anchor, live, rec[:, 0])
        take = drifting & (in2 > inl)
        return torch.where(take[:, None, None, None], rec, poses), take, drifting

    # ------------------------------------------------------------------ #
    # Forward
    # ------------------------------------------------------------------ #
    def _plan(self, *trees) -> bool:
        """Whether this call runs as CUDA graphs (``use_jit`` and inputs on
        the card); records the answer in ``last_call_captured`` and
        ``last_eager_reason``."""
        reason = eager_reason_for(self.use_jit, *trees)
        self.last_call_captured, self.last_eager_reason = reason is None, reason
        return reason is None

    def _runner(self, captured: bool, grad: bool):
        """How a call runs a frame body: ``run(name, body, args, options)``.
        Captured, from the body's graphs: under autograd (``grad``) the
        forward and backward graphs of ``frame_graphs.grad`` (the result is
        the caller's), else the no-grad frame graph (the result is the
        graph's static outputs, which the next replay of that graph
        overwrites). Otherwise eagerly, through :meth:`_frame`, each input
        that needs a gradient taken through one view first, as
        :meth:`_online` does: the gradients of its uses inside the body
        reach it summed, as from a captured body."""
        def run(name, body, args, options=()):
            if not captured:
                if needs_grad(*args):
                    args = _through_views(args)
                return self._frame(body, *args)
            if grad:
                # the backward's predicates read through _read_back, looked up
                # when they are read
                return self.frame_graphs.grad(name, body, args, options, remat=self.remat,
                                              read=lambda flags: _read_back(flags))
            return self.frame_graphs(name, body, args, options)

        return run

    def _online(self, captured: bool, name: str, body, args: tuple, options: tuple = ()):
        r"""An online call's ``body(*args)`` (:meth:`step`, :meth:`localize`,
        :meth:`map_update`). ``captured``, from its graphs, as the JAX
        package jits these calls: under autograd from ``frame_graphs.grad``
        (an online loop is open-ended, so each call is one
        ``torch.autograd.Function`` with its own saved inputs and, without
        ``remat``, its own arena: nothing of one call leaks into the next),
        else from the no-grad graph, whose outputs are copied. Either way
        the result is the caller's.

        Eagerly, through :meth:`_frame`, with each input that needs a
        gradient taken through one view first: the gradients of its uses
        inside the call are summed there before the caller's uses' are
        added, in the order a captured call's backward sums them, so both
        give the same bits."""
        if captured:
            if needs_grad(*args):
                return self.frame_graphs.grad(name, body, args, options, remat=self.remat)
            return clone_tree(self.frame_graphs(name, body, args, options))
        if needs_grad(*args):
            args = _through_views(args)
        return self._frame(body, *args)

    def _frame(self, body, *args):
        """One frame's ``body(*args)``, under per-frame checkpointing when
        ``remat`` is set. Non-reentrant: the body takes and returns
        dataclasses of tensors, whose gradients the reentrant form would
        drop. The body draws no random numbers, so no RNG state is kept."""
        if not self.remat:
            return body(*args)
        return checkpoint(body, *args, use_reentrant=False, preserve_rng_state=False)

    def _predicted(self, cv: bool, prev_pose: torch.Tensor, prev_delta: torch.Tensor,
                   frame: RGBDImages) -> RGBDImages:
        """``frame`` at the predicted pose: the constant-velocity prediction
        with ``cv``, else the previous pose."""
        pred = self._predict(prev_pose, prev_delta) if cv else prev_pose
        return frame.with_poses(pred[:, None])

    def _fuse(self, cv: bool, map_pc: Pointclouds, pose: torch.Tensor, prev_pose: torch.Tensor,
              frame: RGBDImages, anchor=None, drifting=None, cond=None, keep=None):
        r"""A tracked frame's second half at the chosen ``pose (B, 1, 4,
        4)``: the map update, the world-frame motion (with ``cv``; else
        None) and, given an ``anchor``, its refresh at the pose except where
        ``drifting`` (a refresh there would bake the drift into the
        reference); with ``cond`` (:func:`~gradslam_torch.utils.graphs.
        when`) the refresh is a conditional that leaves the anchor whole
        where ``keep`` (every sequence drifting) holds. Returns ``(map, pose
        (B, 4, 4), motion, anchor)``: the pose's last use, so that under
        autograd its gradient from later frames comes first in this body's
        backward, as eagerly."""
        live = frame.with_poses(pose)
        map_pc = self._map(map_pc, live)
        delta = None
        if cv:  # world-frame motion of this frame, the next prediction
            delta = compose_transformations(pose[:, 0], inverse_transformation(prev_pose))
        if anchor is not None:
            if cond is None:  # a body of its own, as the conditional's
                anchor = self._refreshed(*_through_views((live, anchor, drifting)))
            else:
                anchor = tuple(cond(~keep, self._refreshed, (live, anchor, drifting),
                                    [t.clone() for t in anchor]))
        return map_pc, pose[:, 0], delta, anchor

    def _refreshed(self, live: RGBDImages, anchor: Tuple[torch.Tensor, ...],
                   drifting: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """The anchor refreshed from ``live`` (at its pose) except where
        ``drifting``."""
        return tuple(
            torch.where(drifting.reshape((-1,) + (1,) * (new.ndim - 1)), old, new)
            for new, old in zip(self._anchor_snapshot(live), anchor))

    def _track_unarmed(self, cv: bool, map_pc: Pointclouds, prev_pose: torch.Tensor,
                       prev_delta: Optional[torch.Tensor], frame: RGBDImages):
        """The unarmed tracked frame, one body: predict, localize, fuse.
        Returns ``(map, pose (B, 4, 4), motion)``; without ``cv`` the motion
        is ``prev_delta``."""
        live = self._predicted(cv, prev_pose, prev_delta, frame)
        pose = self._localize(map_pc, live, live)
        map_pc, pose, delta, _ = self._fuse(cv, map_pc, pose, prev_pose, frame)
        return map_pc, pose, delta if cv else prev_delta

    def _gate(self, cv: bool, map_pc: Pointclouds, prev_pose: torch.Tensor,
              prev_delta: torch.Tensor, anchor, frame: RGBDImages):
        r"""The armed frame's first body: predict, localize, and the gates
        on the solved pose: the health gate and, given an ``anchor``, the
        drift gate. Returns ``(pose (B, 1, 4, 4), inlier, anchor inliers,
        drifting, flags, map, anchor)``; the anchor's inliers and
        ``drifting`` are None without one. ``flags`` decide the branches
        (read by the host, or the predicates of :meth:`_armed`'s
        conditionals): any unhealthy, and with an anchor any and all
        drifting.

        The map and the anchor come back as they went in, and the branches
        and the fuse body read these."""
        live = self._predicted(cv, prev_pose, prev_delta, frame)
        pose, window = self._localize(map_pc, live, live, return_window=True)
        inlier = self._health_gate(live, pose, window)
        unhealthy = (inlier < self.relocalize_below).any()
        if anchor is None:
            return pose, inlier, None, None, unhealthy[None], map_pc, anchor
        inl, drifting = self._anchor_gate(anchor, live, pose)
        flags = torch.stack([unhealthy, drifting.any(), drifting.all()])
        return pose, inlier, inl, drifting, flags, map_pc, anchor

    def _refresh_frame(self, f: int) -> bool:
        """Whether global frame ``f`` refreshes the anchor (where no sequence
        drifts): every ``anchor_every``-th frame."""
        return self.anchor_every > 0 and f % self.anchor_every == 0

    def _track(self, map_pc: Pointclouds, prev_pose: torch.Tensor, prev_delta: torch.Tensor,
               anchor, refresh: bool, frame: RGBDImages, run=None, cond=None, deltas=None):
        r"""One armed tracked frame, in the JAX body's order: the gate body
        (:meth:`_gate`), the relocalization where any sequence is unhealthy
        (:meth:`_relocalize`, with an anchor followed by the drift gate on
        the pose it leaves), the anchor re-solve where any drifts
        (:meth:`_anchor_resolve`), and the fuse body (:meth:`_fuse`; on a
        ``refresh`` frame, :meth:`_refresh_frame`, with the anchor's
        refresh where some sequence is not drifting). ``frame`` is the
        sequence-length-1 frame (its poses are not read).

        ``cond`` None decides on the host, eagerly: one read back of the
        gate's flags (and one more of the drift gate's after a
        relocalization with an anchor), and each branch a body of its own
        run through ``run`` (:meth:`_runner`'s eager form by default; the
        names ``'gate'``, ``'relocalize'``, ``'anchor'``, ``'fuse'``) on
        the frames that need it. ``cond`` given
        (:func:`~gradslam_torch.utils.graphs.when`, inside :meth:`_armed`)
        decides each branch on the device, as JAX's ``lax.cond``: the
        branch's outputs start as copies of what passes through (no
        sequence taking its pose), and nothing is read; ``deltas`` are then
        the relocalization grid's, an input of the body.

        Returns ``(map, pose (B, 4, 4), motion (B, 4, 4), anchor,
        events)``: ``events`` holds the gate's reading (``'health'``) and,
        for each branch
        (``'relocalize'``, ``'anchor'``), the sequences ``(B,)`` that took
        its pose: on the host None where the branch did not run, on the
        device all false there."""
        run = run or self._runner(False, False)
        cv = self.motion_model == "constant_velocity"
        if needs_grad(map_pc, prev_pose, prev_delta, anchor, frame):
            # the frame's inputs through one view each: the gradients of their
            # uses in the frame's bodies sum there first, as they do in the
            # backward of a frame captured as one graph (:meth:`_armed`)
            map_pc, prev_pose, prev_delta, anchor, frame = _through_views(
                (map_pc, prev_pose, prev_delta, anchor, frame))
        pose, inlier, inl, drifting, flags, map_pc, anchor = run(
            "gate", functools.partial(self._gate, cv),
            (map_pc, prev_pose, prev_delta, anchor, frame), (cv,))
        events = {"health": inlier, "relocalize": None, "anchor": None}
        untaken = None  # on the device, what a branch that does not run leaves
        if cond is None:
            flags = _read_back(flags)
            if flags[0]:
                deltas = self._grid_deltas(pose)
        else:  # no sequence took its pose
            untaken = torch.zeros_like(inlier, dtype=torch.bool)

        def branch(pred, name, body, args, through):
            if cond is None:
                return run(name, body, args) if pred else None
            return cond(pred, body, args, [t.clone() for t in through])

        drift = flags[1:]  # any and all drifting, with an anchor
        out = branch(flags[0], "relocalize", self._relocalize,
                     (map_pc, frame, pose, inlier, deltas, anchor),
                     (pose, untaken, *(() if anchor is None else (inl, drifting, drift))))
        if out is not None:
            pose, events["relocalize"] = out[:2]
            if anchor is not None:  # the drift gate on the pose the branch left
                inl, drifting, drift = out[2:]
                if cond is None:
                    drift = _read_back(drift)
        if anchor is not None:
            out = branch(drift[0], "anchor", self._anchor_resolve,
                         (anchor, frame, pose, inl, drifting), (pose, untaken, drifting))
            if out is not None:
                pose, events["anchor"], drifting = out
        refresh = refresh and anchor is not None
        if cond is None:
            refresh = refresh and not drift[1]
            fuse = functools.partial(self._fuse, cv)
        else:  # the refresh where some sequence is not drifting
            fuse = functools.partial(self._fuse, cv, cond=cond, keep=drift[1] if refresh else None)
        map_pc, pose, delta, fresh = run(
            "fuse", fuse, (map_pc, pose, prev_pose, frame, *((anchor, drifting) if refresh else ())),
            (cv, refresh))
        return map_pc, pose, delta if cv else prev_delta, fresh if refresh else anchor, events

    def _armed(self, refresh: bool, map_pc: Pointclouds, prev_pose: torch.Tensor,
               prev_delta: torch.Tensor, anchor, deltas: torch.Tensor, frame: RGBDImages):
        r"""The armed tracked frame as one body, captured as one graph whose
        branches are conditional nodes decided on the device, as the JAX
        scan body runs its three ``lax.cond``\ s: :meth:`_track` with
        :func:`~gradslam_torch.utils.graphs.when` (under autograd the
        forward of one ``FrameGraphs.grad`` call, whose backward graph
        decides its branches' VJPs on the same predicates, with ``remat``
        after recomputing it; each body's inputs that need a gradient go
        through one view first, as eagerly). Returns ``(map, pose (B,
        4, 4), motion, anchor, health, relocalization taken, anchor re-solve
        taken)`` (the last None without an anchor); whether each branch ran
        stays on the device with the graph's predicates
        (:meth:`~gradslam_torch.utils.graphs.FrameGraphs.settle`)."""
        def direct(name, body, args, options=()):
            if needs_grad(*args):  # as eagerly (:meth:`_runner`)
                args = _through_views(args)
            return body(*args)

        map_pc, pose, delta, anchor, events = self._track(
            map_pc, prev_pose, prev_delta, anchor, refresh, frame, run=direct, cond=when,
            deltas=deltas)
        return map_pc, pose, delta, anchor, events["health"], events["relocalize"], events["anchor"]

    def _localize_step(self, map_pc: Pointclouds, live: RGBDImages, prev_pose: torch.Tensor,
                       prev_transform: Optional[torch.Tensor]) -> torch.Tensor:
        """:meth:`localize`'s body: predict, then solve unarmed."""
        live = self._predicted(prev_transform is not None, prev_pose, prev_transform, live)
        return self._localize(map_pc, live, live)

    @staticmethod
    def _predict(prev_pose: torch.Tensor, prev_delta: torch.Tensor) -> torch.Tensor:
        """The constant-velocity prediction ``prev_delta @ prev_pose``,
        re-projected onto SO(3): the chain pose @ inv(prev) @ pose doubles
        the rotation's orthonormality error each frame."""
        return orthonormalize_rotations(compose_transformations(prev_delta, prev_pose))

    # ------------------------------------------------------------------ #
    # Online API
    # ------------------------------------------------------------------ #
    def step(
        self,
        pointclouds: Pointclouds,
        live_frame: RGBDImages,
        prev_frame: Optional[RGBDImages] = None,
        prev_transform: Optional[torch.Tensor] = None,
    ) -> Tuple[Pointclouds, torch.Tensor]:
        r"""One online SLAM step: returns ``(pointclouds, poses (B, 1, 4,
        4))``. With ``prev_frame`` None, or with ``odom='gt'``, the map is
        updated at ``live_frame``'s own poses; otherwise the live frame is
        tracked from ``prev_frame``'s pose (its imagery is not read) and
        fused at the solved pose, through the forward's own per-frame body.

        ``prev_transform``: optional ``(B, 4, 4)`` world-frame motion of the
        previous step (``pose_prev @ inv(pose_prevprev)``), the
        constant-velocity prior: the solve starts from (and the association
        window projects at) ``prev_transform @ prev_pose``, re-projected
        onto SO(3). ``step`` keeps no state, so the caller threads it; with
        the identity on the first tracked frame and the returned poses'
        motion after, a step loop replays the constant-velocity
        :meth:`forward`. A step runs no recovery branch and no
        ``prune_every`` (there is no frame counter): a step loop calls
        :func:`~gradslam_torch.slam.fusionutils.prune_map` itself.

        With ``use_jit`` on the card the step replays the CUDA graph of its
        key (the map update, or the tracked frame), under autograd its
        forward's and its backward's (:meth:`_online`); the result is the
        caller's, and later steps leave it and its gradients alone.
        """
        if not isinstance(live_frame, RGBDImages):
            raise TypeError(
                f"Expected live_frame to be of type RGBDImages. Got {type(live_frame)}.")
        if prev_frame is not None and not isinstance(prev_frame, RGBDImages):
            raise TypeError(
                f"Expected prev_frame to be of type RGBDImages or None. Got {type(prev_frame)}.")
        if prev_frame is not None and self.odom != "gt" and prev_frame.poses is None:
            raise ValueError("`prev_frame` should have poses, but did not.")
        if (prev_frame is None or self.odom == "gt") and live_frame.poses is None:
            raise ValueError(
                "`live_frame` must have poses when `prev_frame` is None or `odom='gt'`.")
        _check_prev_transform(prev_transform, live_frame)
        self._check_features(live_frame, "live_frame carries")
        live_frame = self._with_normal_pitch(live_frame.to_channels_last())
        prev_pose = None if prev_frame is None else prev_frame.poses
        captured = self._plan(pointclouds, live_frame, prev_pose, prev_transform)
        if prev_frame is None or self.odom == "gt":
            if prev_frame is None and self.odom != "gt":
                # frame 0's bootstrap passes no prev_frame into an empty map;
                # a later step without one fuses at a stale pose (one read
                # back of the counters)
                if bool((pointclouds.num_points > 0).any()):
                    warnings.warn(
                        f"`prev_frame` was None despite odom='{self.odom}'; skipping odometry "
                        "and using `live_frame.poses`. Thread the previous frame through "
                        "step() to enable tracking.", stacklevel=2)
            elif prev_frame is not None:
                warnings.warn("`prev_frame` is not used when `odom='gt'`.", stacklevel=2)
            map_pc = self._online(captured, "map", self._map, (pointclouds, live_frame))
            return map_pc, live_frame.poses
        cv = prev_transform is not None
        args = (pointclouds, prev_frame.poses[:, 0], prev_transform, live_frame)
        map_pc, pose, _ = self._online(
            captured, "track", functools.partial(self._track_unarmed, cv), args, (cv,))
        return map_pc, pose[:, None]

    def localize(
        self,
        pointclouds: Pointclouds,
        live_frame: RGBDImages,
        prev_frame: RGBDImages,
        prev_transform: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        r"""The odometry half of :meth:`step`, without the map update:
        returns poses ``(B, 1, 4, 4)``. With :meth:`map_update` it splits a
        step for serving loops that check tracking before fusing::

            poses = slam.localize(pc, live, prev)
            h = tracking_health(pc, live.with_poses(poses))
            if h["inlier_frac"][0] < threshold:
                poses, info = relocalize(pc, live, anchors)
            pc = slam.map_update(pc, live.with_poses(poses))

        Arguments as :meth:`step`'s. Not available for ``odom='gt'``: there
        is nothing to solve. Captured as :meth:`step` is."""
        if self.odom == "gt":
            raise ValueError(
                "localize is not available for odom='gt'; ground-truth pipelines use the "
                "frame's own poses.")
        if not isinstance(live_frame, RGBDImages):
            raise TypeError(
                f"Expected live_frame to be of type RGBDImages. Got {type(live_frame)}.")
        if not isinstance(prev_frame, RGBDImages):
            raise TypeError(
                f"Expected prev_frame to be of type RGBDImages. Got {type(prev_frame)}.")
        if prev_frame.poses is None:
            raise ValueError("`prev_frame` should have poses, but did not.")
        _check_prev_transform(prev_transform, live_frame)
        live = self._with_normal_pitch(live_frame.to_channels_last())
        args = (pointclouds, live, prev_frame.poses[:, 0], prev_transform)
        return self._online(self._plan(*args), "localize", self._localize_step, args)

    def map_update(self, pointclouds: Pointclouds, live_frame: RGBDImages) -> Pointclouds:
        r"""The map half of :meth:`step`: fuse ``live_frame`` at its own
        poses. Captured as :meth:`step` is."""
        if not isinstance(live_frame, RGBDImages):
            raise TypeError(
                f"Expected live_frame to be of type RGBDImages. Got {type(live_frame)}.")
        if live_frame.poses is None:
            raise ValueError("live_frame must carry poses to fuse at.")
        live = self._with_normal_pitch(live_frame.to_channels_last())
        return self._online(self._plan(pointclouds, live), "map", self._map, (pointclouds, live))

    def forward(self, frames: RGBDImages) -> Tuple[Pointclouds, torch.Tensor]:
        r"""Run SLAM over a batch of sequences. Returns ``(pointclouds,
        poses (B, L, 4, 4))``. With ``use_jit`` on the card each frame
        replays its capacity segment's CUDA graph, under autograd its
        forward's and its backward's; the results are copies that later
        calls leave alone."""
        if not isinstance(frames, RGBDImages):
            raise TypeError(f"Expected frames to be of type RGBDImages. Got {type(frames)}.")
        if self.odom == "gt" and frames.poses is None:
            raise ValueError("`frames` must have poses when `odom='gt'`.")
        self._check_features(frames, "frames carry")
        frames = self._with_normal_pitch(frames.to_channels_last())
        schedule = self._capacity_schedule(frames)
        captured = self._plan(frames)
        grad = captured and needs_grad(frames)
        if self.odom != "gt":
            out, regrew = self._tracked(frames, schedule, captured, grad)
            if regrew:  # a conditional body's store grew: the forward again, once
                del out  # the first run's graph, before the second's
                out, regrew = self._tracked(frames, schedule, captured, grad)
                if regrew:
                    raise RuntimeError("a conditional body's store grew twice in one forward")
            return out
        map_pc = self.empty_map(frames.shape[0], schedule[0][1], device=frames.device,
                                dtype=frames.dtype)
        run = self._runner(captured, grad)
        start = 0
        for n, cap_seg in schedule:
            map_pc = map_pc.with_capacity(cap_seg)
            for sub_n, prune_after in split_prune_segments(start, n, self.prune_every):
                for i in range(start, start + sub_n):
                    map_pc = run("map", self._map, (map_pc, frames[:, i]))
                if prune_after:
                    map_pc = self._prune(map_pc)
                start += sub_n
        # a no-grad replay's outputs are the graph's: what is kept is a copy
        return (clone_tree(map_pc) if captured and not grad else map_pc), frames.poses

    def _tracked(self, frames: RGBDImages, schedule: list, captured: bool, grad: bool):
        r"""The tracked ``forward`` (odometry on), its results and whether
        its read of the armed frames' predicates grew a conditional body's
        store (captured under autograd without ``remat``: the pushes past a
        store's capacity stored nothing, the key's graphs are captured
        again at its next call, and the caller runs the forward again;
        ``FrameGraphs.settle``)."""
        B = frames.shape[0]
        map_pc = self.empty_map(B, schedule[0][1], device=frames.device, dtype=frames.dtype)
        run = self._runner(captured, grad)
        # a no-grad replay's outputs are the graph's: what is kept is a copy
        owned = clone_tree if captured and not grad else (lambda tree: tree)
        # bootstrap frame 0 at the provided (or identity) pose, then track
        # frame to map, each solve starting at the prediction
        if frames.poses is not None:
            prev_pose = frames.poses[:, 0]
        else:
            prev_pose = torch.eye(4, dtype=frames.dtype, device=frames.device).expand(B, 4, 4)
        poses = [prev_pose]
        live0 = frames[:, 0].with_poses(prev_pose[:, None])
        map_pc = self._map(map_pc, live0)
        if self.prune_every == 1:  # (0 + 1) % prune_every == 0 only then
            map_pc = self._prune(map_pc)
        log = self.recovery_log = {"health": [], "relocalize": [], "anchor": []}
        prev_delta = torch.eye(4, dtype=frames.dtype, device=frames.device).expand(B, 4, 4)
        # the drift anchor starts from the (trusted) bootstrap frame
        anchor = self._anchor_snapshot(live0) if self.anchor_every > 0 else None
        cv = self.motion_model == "constant_velocity"
        track = functools.partial(self._track_unarmed, cv)
        # armed and captured: one graph a frame (under grad its forward's and
        # its backward's), its branches decided on the device; the branch
        # frames are read once, at the end (and the backward's once, after
        # its last frame)
        on_device = self.relocalize_below > 0 and armed_on_device(captured, grad, self.remat)
        deltas = self._grid_deltas(prev_pose) if on_device else None
        armed_frames = []
        start = 0  # tracked frames done; global frame = start + 1
        for i, (n, cap_seg) in enumerate(schedule):
            n_track = n - 1 if i == 0 else n  # frame 0 was mapped above
            map_pc = map_pc.with_capacity(cap_seg)
            for sub_n, prune_after in split_prune_segments(start + 1, n_track, self.prune_every):
                for f in range(start + 1, start + 1 + sub_n):
                    refresh = self._refresh_frame(f)
                    if on_device:
                        map_pc, prev_pose, prev_delta, anchor, health, *_ = run(
                            "armed", functools.partial(self._armed, refresh),
                            (map_pc, prev_pose, prev_delta, anchor, deltas, frames[:, f]),
                            (cv, refresh, anchor is not None))
                        log["health"].append(owned(health))
                        armed_frames.append(f)
                    elif self.relocalize_below > 0:
                        map_pc, prev_pose, prev_delta, anchor, events = self._track(
                            map_pc, prev_pose, prev_delta, anchor, refresh, frames[:, f])
                        log["health"].append(events["health"])
                        for kind in ("relocalize", "anchor"):
                            if events[kind] is not None:
                                log[kind].append(f)
                    else:
                        map_pc, prev_pose, prev_delta = run(
                            "track", track, (map_pc, prev_pose, prev_delta, frames[:, f]), (cv,))
                    # a copy: the next frame's first replay overwrites a pose its
                    # graph output
                    prev_pose = owned(prev_pose)
                    poses.append(prev_pose)
                if prune_after:
                    map_pc = self._prune(map_pc)
                start += sub_n
        regrew = False
        if armed_frames:  # the one read: which branches ran, and their launches
            took = self.frame_graphs.settle(_read_back)[-len(armed_frames):]
            regrew = self.frame_graphs.regrew
            for f, ran in zip(armed_frames, took):
                for kind, r in zip(("relocalize", "anchor"), ran):
                    if r:
                        log[kind].append(f)
        return (owned(map_pc), torch.stack(poses, dim=1)), regrew
