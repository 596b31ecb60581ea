r"""Map-axis-sharded SLAM across processes on ``torch.distributed``
(counterpart of ``gradslam_tpu/parallel/map_sharded.py``; the reference is
single-device, SURVEY §2.3).

For maps too large for one card's memory, the fixed-capacity buffer's point
axis is sharded over a mesh axis: each of the K ranks owns ``CAP/K`` rows of
points/normals/colors/ccounts plus its own live counter. One fusion step
(reference fusionutils.py:761-789 semantics) becomes:

1. **Local association**: each rank projects ITS map rows into the frame,
   gates them against the (replicated) frame, and selects per-pixel winners
   among its own rows by (pixel, -ccount, ray distance, global row index),
   the exact criterion of fusionutils.py:509-544. The port's stable
   ``_lexsort`` breaks the last tie by row position, which is the index.
2. **Cross-shard winner reduction**: each rank all-gathers its per-pixel
   winner table (ccount, ray distance, global row index: ``3 * H*W * 4``
   bytes a sequence, one collective) over the map axis and folds the K
   tables k = 0..K-1 with a strict ``<``, so a tie keeps the smaller global
   index.
3. **Row-side merge + strided append**: the rank owning a pixel's winning
   row merges it in place (confidence-weighted average, gathering frame data
   at the row's own pixel); un-corresponded valid pixels are dealt
   round-robin (the pixel with append rank ``r`` goes to rank ``r % K``, at
   its tail ``nloc + r // K``), so the map grows balanced with no traffic.
   Each rank's rows therefore equal the JAX package's shard of the same
   rank, row for row.

Tracked odometry (``odom='icp'|'gradicp'``): each rank compacts its active,
strided map rows (reference icputils.py:548-621 semantics) into a window of
``icp_capacity`` rows, the windows are all-gathered into the ICP target, and
every rank runs the same solve on bit-identical inputs, so every rank gets
the same pose. Projective association (``odom_assoc='projective'``) gathers
no window: each rank builds point-to-plane rows for its own window and only
the 6x6 normal equations and the error sums are all-reduced.

Every collective goes through :mod:`~gradslam_torch.parallel.collectives`,
which counts its bytes by tag: ``'fusion'`` (the winner tables), ``'window'``
(the ICP windows and their counts), ``'normal_eq'`` (projective sums),
``'guard'`` (the robust step guard's cloud statistics), ``'counters'`` and
``'poses'`` (the outputs). The per-pixel tables hold the global row index as
int32 (it is below ``map_capacity``); every other index, count and sort key
is int64. On the card the winner tables, the append map and the window
compaction go through the scatter dispatchers (the hand-written scatter
kernel) and every 1-NN level through the 1-NN kernel.

With ``use_jit`` (the default, as in JAX, whose whole frame scan is one
jitted ``shard_map``) each frame's body after the first replays a CUDA
graph on the card, its collectives captured in it
(:mod:`~gradslam_torch.utils.graphs`): a function of its arguments alone
(the state, the poses, the frame's own slices), so one graph serves every
frame and every call.

Winner semantics match the single-device path exactly up to the global row
numbering: appends land at different global rows than a single-device run,
so ties in (ccount, ray distance), i.e. exactly duplicated points, may
tie-break differently. Point sets and confidence mass are identical.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..geometry.geometryutils import (
    compose_transformations,
    inverse_transformation,
    orthonormalize_rotations,
)
from ..geometry.se3utils import se3_exp
from ..odometry.icputils import (
    _ptp_system,
    _safe_sqrt,
    point_to_plane_gradICP,
    point_to_plane_ICP,
    validate_pyramid,
    validate_robust,
)
from ..odometry.projective import projective_associate
from ..ops import nn_points_auto
from ..slam.fusionutils import (
    _lexsort,
    _project_map_points,
    get_alpha,
    pack_colors,
    unpack_colors,
)
from ..slam.icpslam import split_prune_segments
from ..structures.pointclouds import (
    Pointclouds,
    compact_masked,
    gather_rows,
    scatter_rows,
    scatter_rows_into,
)
from ..structures.rgbdimages import RGBDImages
from ..utils.graphs import FrameGraphs, clone_tree, eager_reason_for
from ..utils.precision import disable_tf32
from . import collectives
from .sharding import make_mesh

__all__ = ["ShardedMap", "MapShardedPointFusion", "nn_points_map_sharded"]


def _group_of(mesh: Optional[DeviceMesh], axis_name: str):
    """``(group, rank in it, its size)`` of a mesh axis; the default group
    when ``mesh`` is None."""
    group = dist.group.WORLD if mesh is None else mesh.get_group(axis_name)
    return group, dist.get_rank(group), dist.get_world_size(group)


def nn_points_map_sharded(src, tgt_local, tgt_mask_local=None, *, axis_name: str = "map",
                          mesh: Optional[DeviceMesh] = None):
    r"""1-NN against a target cloud sharded along its point axis over the
    mesh axis ``axis_name`` (the whole default group when ``mesh`` is None).

    Each rank solves 1-NN against its local target rows (the 1-NN kernel on
    the card), then one all-gather of the (distance, global index) pairs
    folds to the global winner: the same result as single-device
    ``nn_points`` on the concatenated target (ties resolve to the smallest
    global index), bit-identical on every rank. Returns ``(dist, idx)``, the
    index int64."""
    group, shard, K = _group_of(mesh, axis_name)
    d, i = nn_points_auto(src, tgt_local, tgt_mask_local)
    gi = i.to(torch.int64) + shard * tgt_local.shape[-2]
    ad = collectives.all_gather(d, group, "nn")
    ai = collectives.all_gather(gi, group, "nn")
    best_d, best_i = ad[0], ai[0]
    for k in range(1, K):
        take = ad[k] < best_d  # strict: ties keep the earlier (smaller) index
        best_d = torch.where(take, ad[k], best_d)
        best_i = torch.where(take, ai[k], best_i)
    return best_d, best_i


class ShardedMap(NamedTuple):
    r"""Map buffers sharded along the capacity axis.

    On each rank, ``points/normals/colors/features`` hold that rank's own
    ``(B_local, CAP/K, ·)`` rows (``B_local = B / dp`` on a 2-D mesh);
    ``num_points`` is ``(K, B)``, one live counter per shard and sequence,
    the same on every rank (each shard's valid rows are a prefix of its own
    ``CAP/K``-row slice). ``colors`` is ``(B_local, CAP/K, 1)`` packed (see
    ``fusionutils.pack_colors``) when built with ``quantize_colors=True``.
    ``num_dropped (K, B)`` counts rows each shard had to drop because its
    slice was full. ``mesh`` (with ``axis_name`` and ``batch_axis``) names
    where the rows live; with ``mesh=None`` the buffers are the whole
    ``(B, CAP, ·)`` map, as the JAX package's global arrays are.
    """

    points: torch.Tensor
    normals: torch.Tensor
    colors: torch.Tensor
    features: torch.Tensor
    num_points: torch.Tensor  # (K, B) int64
    num_dropped: torch.Tensor  # (K, B) int64
    mesh: Optional[DeviceMesh] = None
    axis_name: str = "map"
    batch_axis: Optional[str] = None

    def _global(self, buf: torch.Tensor) -> torch.Tensor:
        """The whole ``(B, CAP, ·)`` buffer on every rank."""
        if self.mesh is None:
            return buf
        group, _, _ = _group_of(self.mesh, self.axis_name)
        g = collectives.all_gather(buf, group, "export")  # (K, Bl, C, c)
        g = g.permute(1, 0, 2, 3).reshape(buf.shape[0], -1, buf.shape[-1])
        if self.batch_axis is not None:
            bgroup, _, _ = _group_of(self.mesh, self.batch_axis)
            g = collectives.all_gather(g, bgroup, "export").reshape((-1,) + g.shape[1:])
        return g

    def to_pointclouds(self) -> Pointclouds:
        """Compaction into a standard (unsharded) Pointclouds, the same on
        every rank: the live rows of every shard, shard by shard. Packed
        colors (quantize_colors builds) are unpacked to float AFTER the
        live-row compaction: unpacking the whole padded buffer would take 3x
        the capacity, on maps that are sharded because the capacity is
        huge."""
        packed = self.colors.shape[-1] == 1
        bufs = [self._global(b) for b in (self.points, self.normals, self.colors, self.features)]
        nums = self.num_points.to(bufs[0].device)
        K, B = nums.shape
        C = bufs[0].shape[1] // K
        rows = torch.arange(K * C, device=nums.device)
        keep = (rows % C)[None, :] < nums.T.repeat_interleave(C, dim=1)  # (B, K*C)
        count = keep.sum(dim=1)
        cap = max(int(count.max()), 1)
        dest = torch.where(keep, torch.cumsum(keep.to(torch.int64), dim=1) - 1,
                           torch.full_like(rows[None, :], -1))
        pts, nrm, col, feat = [scatter_rows(cap, dest, b) for b in bufs]
        if packed:
            col = unpack_colors(col) * (torch.arange(cap, device=col.device)
                                        < count[:, None])[..., None]
        return Pointclouds(points=pts, normals=nrm, colors=col, features=feat,
                           num_points=count,
                           num_dropped=self.num_dropped.sum(dim=0).to(count.device))


def _transform_pts(pts, pose):
    """Rigid transform of (B, N, 3) by (B, 4, 4), row by row."""
    R = pose[:, :3, :3]
    t = pose[:, :3, 3]
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]

    def row(i):
        return (R[:, i, 0][:, None] * x + R[:, i, 1][:, None] * y
                + R[:, i, 2][:, None] * z + t[:, i][:, None])

    return torch.stack([row(0), row(1), row(2)], dim=-1)


def _rotate_pts(pts, pose):
    R = pose[:, :3, :3]
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]

    def row(i):
        return R[:, i, 0][:, None] * x + R[:, i, 1][:, None] * y + R[:, i, 2][:, None] * z

    return torch.stack([row(0), row(1), row(2)], dim=-1)


class MapShardedPointFusion:
    r"""PointFusion with the map's point axis sharded over a mesh axis of
    ``torch.distributed`` ranks. Every rank constructs the pipeline and
    calls it with the whole batch of frames; each returns its own shard of
    the map and the whole batch's poses.

    Args:
        map_capacity: GLOBAL capacity; must be divisible by the map-axis
            mesh size.
        mesh: ``DeviceMesh`` to shard over (default: every rank of the
            default group on a 1-D axis ``'map'``, on the card; see
            :func:`~gradslam_torch.parallel.make_mesh`). A 2-D mesh composes
            batch (data) parallelism with map sharding: pass ``batch_axis``
            naming the batch mesh axis and ``axis_name`` naming the map axis
            — each batch block's map lives sharded across that block's
            map-axis subgroup (``mesh.get_group(axis_name)``), and all
            fusion/odometry collectives stay within it.
        batch_axis: name of the mesh axis the batch dim is sharded over
            (2-D meshes only; None = map-only sharding).
        odom: 'gt' (poses given), 'icp' or 'gradicp' (frame-to-map tracking
            with the same solve on every rank and the ICP target
            all-gathered from per-rank active windows).
        odom_assoc: ``'knn'`` (default; all-gathered window, per-iteration
            1-NN) or ``'projective'`` (each rank builds point-to-plane rows
            for its OWN window against the replicated frame image and only
            the 6x6 normal equations are all-reduced, 176 bytes a sequence
            and iteration; no window collective at all). With a
            ``pyramid``, also a per-level list for hybrid schedules
            (``['projective', 'knn']``).
        odom_angle_gate: optional maximum angle (degrees) between the frame
            normal and the associated map normal, both association modes (on
            1-NN levels the strided frame normals ride as 3 extra source
            channels).
        odom_sym_normals: symmetric point-to-plane normals for the
            projective solver (``odom_assoc='projective'`` only).
        odom_subpixel: bilinear (sub-pixel) projective association
            (``odom_assoc='projective'`` only).
        pyramid: optional coarse-to-fine ``[(dsratio, numiters), ...]``
            schedule; each level gathers its own target window and
            warm-starts the next.
        icp_capacity: per-rank active-window size for the ICP target
            (default: the single-device window ``2*ceil(H/ds)*ceil(W/ds)``,
            sized so even a maximally imbalanced shard fits its actives; the
            K ranks therefore hold up to K times the single-device window).
        motion_model: ``'static'`` (default) or ``'constant_velocity'``.
        use_jit: as the JAX package runs the whole frame scan in one
            jitted ``shard_map``, on the card each frame after the first
            replays a CUDA graph of its body with the body's collectives
            (NCCL) captured in it: the gt fusion, or the tracked frame's
            prediction, localization and fusion (one graph a key in
            ``frame_graphs``, :class:`~gradslam_torch.utils.graphs.
            FrameGraphs`; the first call of a key warms up and captures).
            Frame 0, the prune between segments and the final gathers run
            eagerly, as they run outside the JAX scan. ``last_call_captured``
            and ``last_eager_reason`` say how the last call ran (CPU
            tensors and ``use_jit=False`` run eagerly, with the same bits).
            The result is the caller's: later calls leave it alone.
        dist_th / angle_th / sigma and the solver parameters match
            :class:`gradslam_torch.PointFusion` defaults.
    """

    def __init__(
        self,
        *,
        map_capacity: int,
        mesh: Optional[DeviceMesh] = None,
        axis_name: str = "map",
        batch_axis: Optional[str] = None,
        odom: str = "gt",
        odom_assoc: str = "knn",
        odom_angle_gate: Optional[float] = None,
        odom_sym_normals: bool = False,
        odom_subpixel: bool = False,
        dsratio: int = 4,
        numiters: int = 20,
        pyramid: Optional[list] = None,
        damp: float = 1e-8,
        dist_thresh: Optional[float] = None,
        lambda_max: float = 2.0,
        B: float = 1.0,
        B2: float = 1.0,
        nu: float = 200.0,
        lookahead_assoc: str = "fresh",
        motion_model: str = "static",
        robust_loss: Optional[str] = None,
        robust_scale: float = 0.05,
        icp_capacity: Optional[int] = None,
        dist_th: float = 0.05,
        angle_th: float = 20.0,
        sigma: float = 0.6,
        quantize_colors: bool = False,
        feature_channels: int = 0,
        normal_pitch: Optional[int] = None,
        prune_every: int = 0,
        prune_min_confidence: float = 1.5,
        use_jit: bool = True,
    ):
        self.use_jit = bool(use_jit)
        self.frame_graphs = FrameGraphs()
        self.last_call_captured = False
        self.last_eager_reason: Optional[str] = None
        if odom not in ("gt", "icp", "gradicp"):
            raise ValueError(f"Odometry method ({odom}) not supported.")
        if isinstance(odom_assoc, (list, tuple)):
            if pyramid is None or len(odom_assoc) != len(pyramid):
                raise ValueError(
                    "A per-level odom_assoc list requires a pyramid of the "
                    f"same length. Got {odom_assoc!r} with pyramid={pyramid!r}.")
            odom_assoc = tuple(odom_assoc)
            bad = [a for a in odom_assoc if a not in ("knn", "projective")]
            if bad:
                raise ValueError(
                    f"Unknown odom_assoc level(s): {bad!r}. Expected 'knn' or 'projective'.")
        elif odom_assoc not in ("knn", "projective"):
            raise ValueError(
                f"Unknown odom_assoc: {odom_assoc!r}. Expected 'knn' or 'projective'.")
        self.odom_assoc = odom_assoc
        any_projective = (
            "projective" in odom_assoc if isinstance(odom_assoc, tuple)
            else odom_assoc == "projective")
        if odom_angle_gate is not None:
            if odom == "gt":
                raise ValueError(
                    "odom_angle_gate requires tracked odometry "
                    "(odom='icp'/'gradicp'), not odom='gt'.")
            if not (0 < odom_angle_gate <= 180):
                raise ValueError(
                    f"odom_angle_gate must be in (0, 180] degrees or None. "
                    f"Got {odom_angle_gate}.")
        self.odom_dot_gate = (
            None if odom_angle_gate is None else math.cos(math.radians(odom_angle_gate)))
        if odom_sym_normals and not any_projective:
            raise ValueError("odom_sym_normals requires odom_assoc='projective'.")
        self.odom_sym_normals = bool(odom_sym_normals)
        if odom_subpixel and not any_projective:
            raise ValueError("odom_subpixel requires odom_assoc='projective'.")
        self.odom_subpixel = bool(odom_subpixel)
        if normal_pitch is not None and (not isinstance(normal_pitch, int) or normal_pitch < 1):
            raise ValueError(f"normal_pitch must be None or an int >= 1. Got {normal_pitch!r}.")
        self.normal_pitch = normal_pitch
        if mesh is None:
            mesh = make_mesh(axis_name=axis_name)
        names = tuple(mesh.mesh_dim_names or ())
        if axis_name not in names:
            raise ValueError(f"mesh has no axis {axis_name!r} (axes: {names}).")
        if batch_axis is None and len(names) > 1:
            raise ValueError(
                "multi-axis mesh requires batch_axis naming the batch "
                f"(data-parallel) axis (mesh axes: {names}).")
        if batch_axis is not None:
            if batch_axis not in names:
                raise ValueError(f"mesh has no axis {batch_axis!r} (axes: {names}).")
            if batch_axis == axis_name:
                raise ValueError("batch_axis must differ from axis_name.")
        self.mesh = mesh
        self.axis_name = axis_name
        self.batch_axis = batch_axis
        self.K = int(mesh.size(names.index(axis_name)))
        self.dp = int(mesh.size(names.index(batch_axis))) if batch_axis else 1
        if map_capacity % self.K != 0:
            raise ValueError(
                f"map_capacity ({map_capacity}) must be divisible by the "
                f"map-axis mesh size ({self.K}).")
        self.map_capacity = map_capacity
        self.odom = odom
        self.dsratio = dsratio
        self.numiters = numiters
        self.pyramid = validate_pyramid(pyramid)
        self.damp = damp
        self.dist_thresh = dist_thresh
        self.lambda_max = lambda_max
        self.B_lm = B
        self.B2 = B2
        self.nu = nu
        self.lookahead_assoc = lookahead_assoc
        if motion_model not in ("static", "constant_velocity"):
            raise ValueError(
                f"Unknown motion_model: {motion_model!r}. "
                "Expected 'static' or 'constant_velocity'.")
        self.motion_model = motion_model
        validate_robust(robust_loss, robust_scale)
        self.robust_loss = robust_loss
        self.robust_scale = robust_scale
        self.icp_capacity = icp_capacity
        self.dist_th = dist_th
        self.dot_th = math.cos(angle_th * math.pi / 180.0)
        self.sigma = sigma
        self.quantize_colors = bool(quantize_colors)
        if not isinstance(feature_channels, int) or feature_channels < 0:
            raise ValueError(
                f"feature_channels must be a non-negative int. Got {feature_channels!r}.")
        self.feature_channels = feature_channels
        if not isinstance(prune_every, int) or prune_every < 0:
            raise ValueError(f"prune_every must be a non-negative int. Got {prune_every!r}.")
        self.prune_every = prune_every
        self.prune_min_confidence = prune_min_confidence
        self.group, self.shard, _ = _group_of(mesh, axis_name)
        self.batch_group = _group_of(mesh, batch_axis)[0] if batch_axis else None
        self.batch_rank = mesh.get_local_rank(batch_axis) if batch_axis else 0
        disable_tf32()

    # ------------------------------------------------------------------ #

    def __call__(self, frames: RGBDImages) -> Tuple[ShardedMap, torch.Tensor]:
        return self.forward(frames)

    def forward(self, frames: RGBDImages) -> Tuple[ShardedMap, torch.Tensor]:
        r"""Run SLAM over the whole sequence; returns this rank's shard of
        the map and the whole batch's trajectory ``(B, L, 4, 4)``
        (pass-through for 'gt', tracked otherwise). It records no autograd
        graph: the collectives are plain ``torch.distributed`` calls, so a
        gradient would not cross ranks (``DataParallelSLAM`` is the
        differentiable multi-process path)."""
        if self.odom == "gt" and frames.poses is None:
            raise ValueError("MapShardedPointFusion(odom='gt') requires poses.")
        if frames.shape[0] % self.dp != 0:
            raise ValueError(
                f"batch size ({frames.shape[0]}) must be divisible by the "
                f"batch-axis mesh size ({self.dp}).")
        if frames.feature_channels != self.feature_channels:
            raise ValueError(
                f"frames carry {frames.feature_channels} feature channel(s) "
                f"but this pipeline fuses {self.feature_channels} — construct "
                "MapShardedPointFusion(feature_channels=...) to match.")
        # channels-first frames would reshape into scrambled (HW, C) rows
        frames = frames.to_channels_last()
        Bl = frames.shape[0] // self.dp
        frames = frames[self.batch_rank * Bl:(self.batch_rank + 1) * Bl]
        with torch.no_grad():
            return self._forward_impl(frames, self._plan(frames))

    def _plan(self, frames: RGBDImages) -> bool:
        """Whether this call runs as CUDA graphs (``use_jit`` and frames on
        the card); records the answer in ``last_call_captured`` and
        ``last_eager_reason``."""
        reason = eager_reason_for(self.use_jit, frames)
        self.last_call_captured, self.last_eager_reason = reason is None, reason
        return reason is None

    # ------------------------------------------------------------------ #

    def _solve_one(self, src, src_mask, tgt, tgt_normals, tgt_mask,
                   init_T=None, numiters=None, src_normals=None):
        kw = dict(
            initial_transform=init_T,
            numiters=self.numiters if numiters is None else numiters,
            damp=self.damp,
            dist_thresh=self.dist_thresh,
            src_mask=src_mask,
            tgt_mask=tgt_mask,
            lookahead_assoc=self.lookahead_assoc,
            robust_loss=self.robust_loss,
            robust_scale=self.robust_scale,
            src_normals=src_normals,
            dot_gate=self.odom_dot_gate if src_normals is not None else None,
        )
        if self.odom == "icp":
            T, _ = point_to_plane_ICP(src, tgt, tgt_normals, **kw)
        else:
            T, _ = point_to_plane_gradICP(
                src, tgt, tgt_normals, lambda_max=self.lambda_max, B=self.B_lm,
                B2=self.B2, nu=self.nu, **kw)
        return T

    def _forward_impl(self, frames: RGBDImages, captured: bool):
        if self.normal_pitch is not None and frames.normal_pitch != self.normal_pitch:
            import dataclasses

            frames = dataclasses.replace(frames, normal_pitch=self.normal_pitch)
        B, L, H, W = frames.shape
        HW = H * W
        K, C, shard = self.K, self.map_capacity // self.K, self.shard
        base = shard * C
        GCAP = K * C
        dev, dtype = frames.device, frames.rgb_image.dtype
        group = self.group
        ds = self.dsratio
        tracked = self.odom != "gt"
        quantized = self.quantize_colors
        F = self.feature_channels

        # Replicated per-frame data. Vertex/normal maps are kept in the
        # CAMERA frame; each frame applies its (possibly tracked) pose.
        lv = frames.vertex_map.reshape(B, L, HW, 3)
        ln = frames.normal_map.reshape(B, L, HW, 3)
        fc = frames.rgb_image.reshape(B, L, HW, 3)
        fa = get_alpha(frames.vertex_map, sigma=self.sigma, dim=4, keepdim=True).reshape(
            B, L, HW, 1)
        fvalid = frames.valid_depth_mask.reshape(B, L, HW)
        fu = (frames.feature_image.reshape(B, L, HW, F) if F
              else torch.zeros((B, L, HW, 0), dtype=dtype, device=dev))
        intr = frames.intrinsics[:, 0]
        eye4 = torch.eye(4, dtype=dtype, device=dev).expand(B, 4, 4)
        poses_in = frames.poses if frames.poses is not None else eye4[:, None].expand(
            B, L, 4, 4)

        if tracked:
            levels = self.pyramid or [(ds, self.numiters)]
            wins = [self.icp_capacity if self.icp_capacity is not None
                    else 2 * math.ceil(H / ds_l) * math.ceil(W / ds_l) for ds_l, _n in levels]
            assocs = (self.odom_assoc if isinstance(self.odom_assoc, tuple)
                      else (self.odom_assoc,) * len(levels))
        else:
            levels, wins, assocs = [], [], ()
        knn_gate = self.odom_dot_gate is not None
        sl, sv = [], []
        for (ds_l, _n), a_l in zip(levels, assocs):
            # strided local frame clouds (reference icputils.py:623); with an
            # angle gate the frame normals ride as 3 more source channels
            if a_l == "projective":
                sl.append(None)
                sv.append(None)
                continue
            s = frames.vertex_map[:, :, ::ds_l, ::ds_l].reshape(B, L, -1, 3)
            if knn_gate:
                s = torch.cat([s, frames.normal_map[:, :, ::ds_l, ::ds_l].reshape(B, L, -1, 3)],
                              dim=-1)
            sl.append(s)
            sv.append(frames.valid_depth_mask[:, :, ::ds_l, ::ds_l].reshape(B, L, -1))

        dist_th, dot_th = self.dist_th, self.dot_th

        # The frame bodies below are functions of their arguments alone (a
        # captured graph replays them for every frame and every call): the
        # state, the poses and the frame's own slices come in; every
        # constant tensor is built inside.
        def row_ids():
            return torch.arange(C, device=dev)[None, :].expand(B, C)

        def fuse(state, pose, v, n, c, a, vd, uf, intr):
            """One fusion step at the given pose (global-frame v/n in)."""
            pts, nrm, col, feat, nloc, ndrop = state
            lidx = row_ids()
            pixel_ids = torch.arange(HW, device=dev)[None, :].expand(B, HW)
            inf = torch.full((), float("inf"), dtype=dtype, device=dev)
            # the winner table's fills: -ccount and ray distance +inf, the
            # global row index GCAP ("no winner"), its int32 bits as float32
            table_fill = torch.stack([inf, inf, torch.full((), GCAP, dtype=torch.int32,
                                                           device=dev).view(torch.float32)])
            nonpad = lidx < nloc[:, None]
            valid, pix = _project_map_points(pts, nonpad, pose, intr, H, W)
            # in the quantized layout the frame's packed color fills the 8th
            # channel, so the merge needs no separate color gather
            fgeom = torch.cat([v, n, a, pack_colors(c) if quantized
                               else torch.zeros((B, HW, 1), dtype=dtype, device=dev)], dim=-1)
            safe_pix = torch.clamp(pix, max=HW - 1)
            g = gather_rows(fgeom, safe_pix)
            fp, fnrm = g[..., :3], g[..., 3:6]
            is_close = torch.linalg.norm(fp - pts, dim=-1) < dist_th
            is_similar = torch.sum(fnrm * nrm, dim=-1) > dot_th
            eligible = valid & is_close & is_similar
            ray = torch.sum((pts - fp) ** 2, dim=-1)

            k_pix = torch.where(eligible, pix, torch.full_like(pix, HW))
            k_negcc = torch.where(eligible, -feat[..., 0], inf)
            k_ray = torch.where(eligible, ray, inf)
            order = _lexsort([k_ray, k_negcc, k_pix])  # the row is the last key
            s_pix = torch.gather(k_pix, 1, order)
            first = torch.ones_like(s_pix, dtype=torch.bool)
            first[:, 1:] = s_pix[:, 1:] != s_pix[:, :-1]
            s_winner = first & (s_pix < HW)
            rows = torch.stack([torch.gather(k_negcc, 1, order), torch.gather(k_ray, 1, order),
                                (order + base).to(torch.int32).view(torch.float32)], dim=-1)
            table = scatter_rows_into(
                table_fill.expand(B, HW, 3),
                torch.where(s_winner, s_pix, torch.full_like(s_pix, -1)), rows)

            at = collectives.all_gather(table, group, "fusion")  # (K, B, HW, 3)
            a_negcc, a_ray = at[..., 0], at[..., 1]
            a_gidx = at[..., 2].contiguous().view(torch.int32).to(torch.int64)
            b_negcc, b_ray, b_gidx = a_negcc[0], a_ray[0], a_gidx[0]
            for k in range(1, K):
                lt = (a_negcc[k] < b_negcc) | (
                    (a_negcc[k] == b_negcc)
                    & ((a_ray[k] < b_ray) | ((a_ray[k] == b_ray) & (a_gidx[k] < b_gidx))))
                b_negcc = torch.where(lt, a_negcc[k], b_negcc)
                b_ray = torch.where(lt, a_ray[k], b_ray)
                b_gidx = torch.where(lt, a_gidx[k], b_gidx)
            corresponded = b_gidx < GCAP

            local_win = corresponded & (b_gidx >= base) & (b_gidx < base + C)
            new_mask = vd & ~corresponded
            new_rank = torch.cumsum(new_mask.to(torch.int64), dim=-1) - 1
            mine = new_mask & (new_rank % K == shard)
            tail = nloc[:, None] + new_rank // K
            appends = mine & (tail < C)
            dest = torch.where(local_win, b_gidx - base,
                               torch.where(appends, tail, torch.full_like(tail, -1)))
            row_src = scatter_rows(C, dest, pixel_ids, fill=HW)
            touched = row_src < HW
            safe_src = torch.where(touched, row_src, torch.zeros_like(row_src))

            g8 = gather_rows(fgeom, safe_src)
            alpha = g8[..., 6:7]
            # fresh tail rows have feat == 0 (never written), so one uniform
            # weighted-average formula covers merge AND append
            cc_old = feat[..., :1]
            new_cc = cc_old + alpha
            inv = 1.0 / torch.where(new_cc == 0, torch.ones_like(new_cc), new_cc)
            t = touched[..., None]
            pts2 = torch.where(t, (cc_old * pts + alpha * g8[..., :3]) * inv, pts)
            nrm2 = torch.where(t, (cc_old * nrm + alpha * g8[..., 3:6]) * inv, nrm)
            if quantized:
                merged = (cc_old * unpack_colors(col) + alpha * unpack_colors(g8[..., 7:8])) * inv
                col2 = torch.where(t, pack_colors(merged), col)
            else:
                gc = gather_rows(c, safe_src)
                col2 = torch.where(t, (cc_old * col + alpha * gc) * inv, col)
            user2 = (cc_old * feat[..., 1:] + alpha * gather_rows(uf, safe_src)) * inv
            feat2 = torch.where(t, torch.cat([new_cc, user2], dim=-1), feat)
            appended = appends.sum(dim=-1)
            # overflow accounting: rounds dealt to this shard that found its
            # slice full
            dropped = mine.sum(dim=-1) - appended
            return pts2, nrm2, col2, feat2, nloc + appended, ndrop + dropped

        def globalize(pose, v_loc, n_loc, vd):
            m = vd[..., None]
            zero = torch.zeros((), dtype=dtype, device=dev)
            return (torch.where(m, _transform_pts(v_loc, pose), zero),
                    torch.where(m, _rotate_pts(n_loc, pose), zero))

        def knn_level(n_l, win, keep, packed6, pose_prev, X, s_loc, s_valid):
            """One 1-NN level: the gathered windows as the target, the
            strided frame cloud ``s_loc`` as the source, warm-started at
            ``X``."""
            window, counts = compact_masked(packed6, keep, win)
            aw = collectives.all_gather(window, group, "window")  # (K, B, win, 6)
            ac = collectives.all_gather(counts, group, "window")  # (K, B)
            tgt = aw.permute(1, 0, 2, 3).reshape(B, K * win, 6)
            tmask = (torch.arange(win, device=dev)[None, None] < ac[..., None])
            tmask = tmask.permute(1, 0, 2).reshape(B, K * win)
            src = _transform_pts(s_loc[..., :3], pose_prev)
            src_n = _rotate_pts(s_loc[..., 3:6], pose_prev) if knn_gate else None
            return self._solve_one(src, s_valid, tgt[..., :3], tgt[..., 3:6], tmask, X, n_l,
                                   src_n)

        rb_loss, rb_scale = self.robust_loss, self.robust_scale
        dthr = self.dist_thresh
        dgate = self.odom_dot_gate
        lam_max = self.lambda_max
        lam_min = 1.0 / self.lambda_max
        B_lm, B2_lm, nu_lm = self.B_lm, self.B2, self.nu
        reuse_la = self.lookahead_assoc == "reuse"
        is_lm = self.odom == "icp"
        sym_nrm = self.odom_sym_normals
        subpix = self.odom_subpixel

        def proj_rows(m_pts, m_nrm, m_mask, fgeo, pose, intr):
            """Association + masked point-to-plane rows, with the row
            normals (symmetric normals when ``odom_sym_normals``)."""
            s, val, nf = projective_associate(m_pts, m_nrm, m_mask, fgeo, intr, pose, H, W,
                                              dthr, dgate, subpix)
            n = m_nrm
            if sym_nrm:
                nsum = m_nrm + nf
                n = nsum / torch.clamp(torch.linalg.norm(nsum, dim=-1, keepdim=True), min=1e-12)
            A, b = _ptp_system(s, m_pts, n, val, rb_loss, rb_scale)
            return s, val, n, A, b

        def err_sum(b):
            return collectives.all_reduce(torch.sum(b * b, dim=(1, 2)), group, "normal_eq")

        def guard_global(xi, A, s, val):
            """The robust step guard (icputils._guard_robust_step) with the
            cloud statistics summed (and the spread maxed) over the ranks,
            so every rank scales the step identically."""
            m = val.to(s.dtype)[..., None]
            sums = collectives.all_reduce(torch.cat([
                torch.sum(A[..., :3] ** 2, dim=(1, 2))[:, None], torch.sum(m, dim=1),
                torch.sum(s * m, dim=1)], dim=1), group, "guard")
            wmass, cnt, ssum = sums[:, 0], sums[:, 1:2], sums[:, 2:5]
            mass_floor = min(12.0, 0.5 * float(K * val.shape[-1]))
            fade = torch.clamp(wmass / mass_floor, max=1.0)
            c = ssum / torch.clamp(cnt, min=1.0)
            r2 = collectives.all_reduce(
                torch.amax(torch.sum(((s - c[:, None]) * m) ** 2, dim=-1), dim=1), group,
                "guard", op=dist.ReduceOp.MAX)
            radius = 10.0 * rb_scale
            v_t, w_t = xi[:, :3, 0], xi[:, 3:, 0]
            disp = (_safe_sqrt(torch.sum((v_t + torch.linalg.cross(w_t, c, dim=-1)) ** 2, -1))
                    + _safe_sqrt(torch.sum(w_t * w_t, -1)) * _safe_sqrt(r2))
            trust = radius / torch.clamp(disp, min=radius)
            return xi * (fade * trust)[:, None, None]

        def solve_level_projective(m_pts, m_nrm, m_mask, fgeo, pose_prev, X, n_iters, intr):
            dampv = torch.full((B,), self.damp, dtype=dtype, device=dev)
            eye6 = torch.eye(6, dtype=dtype, device=dev)
            for _ in range(n_iters):
                pose = torch.matmul(X, pose_prev)
                s, val, rown, A, b = proj_rows(m_pts, m_nrm, m_mask, fgeo, pose, intr)
                At = A.transpose(-1, -2)
                # one all-reduce of AtA | Atb | err
                red = collectives.all_reduce(torch.cat([
                    torch.matmul(At, A).reshape(B, 36), torch.matmul(At, b).reshape(B, 6),
                    torch.sum(b * b, dim=(1, 2))[:, None]], dim=1), group, "normal_eq")
                AtA, Atb, err = red[:, :36].reshape(B, 6, 6), red[:, 36:42, None], red[:, 42]
                # no error flag read back to the host (icputils.solve_linear_system)
                xi, _info = torch.linalg.solve_ex(AtA + dampv[:, None, None] * eye6, Atb,
                                                  check_errors=False)
                if rb_loss is not None:
                    xi = guard_global(xi, A, s, val)
                rT = se3_exp(xi[:, :, 0])
                one_step = torch.matmul(rT, X)
                if reuse_la:
                    s1 = torch.einsum("bij,bnj->bni", rT[:, :3, :3], s) + rT[:, None, :3, 3]
                    val1 = val
                    if dthr is not None:
                        val1 = val1 & (torch.sum((s1 - m_pts) ** 2, -1) < dthr)
                    _, b1 = _ptp_system(s1, m_pts, rown, val1, rb_loss, rb_scale)
                else:
                    b1 = proj_rows(m_pts, m_nrm, m_mask, fgeo, torch.matmul(one_step, pose_prev),
                                   intr)[4]
                err1 = err_sum(b1)
                if is_lm:  # classic LM accept/reject
                    accept = err1 < err
                    X = torch.where(accept[:, None, None], one_step, X)
                    dampv = torch.where(accept, dampv / 2.0, dampv * 2.0)
                else:  # gradLM smooth blending (reference :496-543)
                    errdiff = torch.clamp(err1 - err, -70.0, 70.0)
                    dmul = lam_min + (lam_max - lam_min) / (1.0 + torch.exp(-B_lm * errdiff))
                    sig = 1.0 / (1.0 + torch.exp(-B2_lm * errdiff)) ** (1.0 / nu_lm)
                    X = torch.matmul(se3_exp(sig[:, None] * xi[:, :, 0]), X)
                    dampv = dampv * dmul
            return X

        def localize(state, pose_prev, v, n, vd, s_loc, s_valid, intr):
            """Frame-to-map odometry (reference icpslam.py:180-247),
            coarse-to-fine over ``levels``: each level dispatches to the
            projective or the 1-NN machinery, threading the same world-frame
            correction ``X`` (both include their warm start in the returned
            transform). ``v``, ``n``, ``vd`` are the frame's camera-frame
            vertices, normals and valid mask, ``s_loc``/``s_valid`` its
            strided clouds, one a level (None on projective levels)."""
            pts, nrm, _col, _feat, nloc, _nd = state
            nonpad = row_ids() < nloc[:, None]
            valid0, pix0 = _project_map_points(pts, nonpad, pose_prev, intr, H, W)
            ph0, pw0 = pix0 // W, pix0 % W
            packed6 = torch.cat([pts, nrm], dim=-1)
            if "projective" in assocs:
                vdf = vd[..., None].to(dtype)
                fgeo = torch.cat([v, n, vdf, torch.zeros_like(vdf)], dim=-1)
            X = torch.eye(4, dtype=dtype, device=dev).expand(B, 4, 4)
            for li, ((ds_l, n_l), a_l) in enumerate(zip(levels, assocs)):
                keep = valid0 & (ph0 % ds_l == 0) & (pw0 % ds_l == 0)
                if a_l == "projective":
                    window, counts = compact_masked(packed6, keep, wins[li])
                    wmask = torch.arange(wins[li], device=dev)[None] < counts[:, None]
                    X = solve_level_projective(window[..., :3], window[..., 3:6], wmask, fgeo,
                                               pose_prev, X, n_l, intr)
                else:
                    X = knn_level(n_l, wins[li], keep, packed6, pose_prev, X, s_loc[li],
                                  s_valid[li])
            return compose_transformations(X, pose_prev)

        def prune_state(state):
            # per-shard Keller prune: compact away local rows whose ccount is
            # below the threshold (no cross-rank traffic); one compaction of
            # the packed buffers
            pts, nrm, col, feat, nloc, ndrop = state
            keep = (row_ids() < nloc[:, None]) & (feat[..., 0] >= self.prune_min_confidence)
            packed, cnt = compact_masked(torch.cat([pts, nrm, col, feat], dim=-1), keep, C)
            cw = col.shape[-1]
            return (packed[..., :3], packed[..., 3:6], packed[..., 6:6 + cw],
                    packed[..., 6 + cw:], cnt, ndrop)

        def fuse_frame(state, pose, v, n, c, a, vd, uf, intr):
            """A gt frame's body: fuse at the given pose."""
            gv, gn = globalize(pose, v, n, vd)
            return fuse(state, pose, gv, gn, c, a, vd, uf, intr)

        cv = self.motion_model == "constant_velocity"

        def track_frame(state, prev_pose, prev_delta, v, n, c, a, vd, uf, s_loc, s_valid, intr):
            """A tracked frame's body: the prediction (constant velocity:
            solve from, and project the association window at, the
            predicted camera, re-projected onto SO(3), as ICPSLAM does),
            the localization and the fusion at the solved pose. Returns
            ``(state, pose, motion)``; without ``cv`` the motion is None."""
            pred = (orthonormalize_rotations(compose_transformations(prev_delta, prev_pose))
                    if cv else prev_pose)
            pose = localize(state, pred, v, n, vd, s_loc, s_valid, intr)
            delta = (compose_transformations(pose, inverse_transformation(prev_pose))
                     if cv else None)
            return fuse_frame(state, pose, v, n, c, a, vd, uf, intr), pose, delta

        def frame_args(f):
            """Frame ``f``'s own slices, the bodies' frame arguments."""
            return (lv[:, f], ln[:, f], fc[:, f], fa[:, f], fvalid[:, f], fu[:, f])

        def run(name, body, args):
            # captured: the result is the graph's static outputs, which the
            # next replay overwrites
            return self.frame_graphs(name, body, args) if captured else body(*args)

        owned = clone_tree if captured else (lambda tree: tree)

        zeros3 = torch.zeros((B, C, 3), dtype=dtype, device=dev)
        counter = torch.zeros((B,), dtype=torch.int64, device=dev)
        state = (zeros3, zeros3.clone(),
                 torch.zeros((B, C, 1 if quantized else 3), dtype=dtype, device=dev),
                 torch.zeros((B, C, 1 + F), dtype=dtype, device=dev), counter, counter.clone())

        pose0 = poses_in[:, 0]
        state = fuse_frame(state, pose0, *frame_args(0), intr)  # frame 0 eagerly
        if self.prune_every == 1:  # (0 + 1) % k == 0 iff every frame
            state = prune_state(state)
        poses = [pose0]
        prev_pose, prev_delta = pose0, eye4 if cv else None
        start = 1
        for sub_n, prune_after in split_prune_segments(1, L - 1, self.prune_every):
            for f in range(start, start + sub_n):
                if not tracked:
                    state = run("fuse", fuse_frame, (state, poses_in[:, f], *frame_args(f), intr))
                    continue
                s_f = tuple(None if s is None else s[:, f] for s in sl)
                v_f = tuple(None if s is None else s[:, f] for s in sv)
                state, pose, prev_delta = run(
                    "track", track_frame,
                    (state, prev_pose, prev_delta, *frame_args(f), s_f, v_f, intr))
                prev_pose = owned(pose)
                poses.append(prev_pose)
            start += sub_n
            if prune_after:
                state = prune_state(state)
        poses_out = poses_in if not tracked else torch.stack(poses, dim=1)

        pts, nrm, col, feat, nloc, ndrop = owned(state)
        counters = collectives.all_gather(torch.stack([nloc, ndrop]), group, "counters")
        if self.batch_group is not None:  # (dp, K, 2, Bl) -> (K, 2, B)
            counters = collectives.all_gather(counters, self.batch_group, "counters")
            counters = counters.permute(1, 2, 0, 3).reshape(K, 2, -1)
            poses_out = collectives.all_gather(poses_out.contiguous(), self.batch_group,
                                               "poses").reshape((-1,) + poses_out.shape[1:])
        smap = ShardedMap(pts, nrm, col, feat, counters[:, 0], counters[:, 1],
                          mesh=self.mesh, axis_name=self.axis_name, batch_axis=self.batch_axis)
        return smap, poses_out
