r"""Tracking health: how well a frame at a pose agrees with the map.

Counterpart of ``gradslam_tpu/slam/health.py``: ``keyframe_anchor`` (:57),
``tracking_health`` (:99) with ``method='knn'`` and ``method='projective'``,
``_FINITE_DIST`` (:191), ``_association_health`` (:194),
``_window_health_knn`` (:271), ``_window_health_projective`` (:304) and
``_projective_health`` (:351). The statistic is the solver's own
association, evaluated at the pose under test: the fraction of rows whose
point-to-plane residual lies within ``robust_scale``. The 1-NN forms call
:func:`~gradslam_torch.ops.nn_points_auto`, so on the card they run the
hand-written 1-NN kernel; the projective forms run no search.

Every function takes an explicit leading batch dimension (the JAX package
``vmap``-s single-frame functions). The packed frame image is the
projective odometry's own :func:`~gradslam_torch.odometry.projective.
pack_frame_geom`.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from ..odometry.icputils import downsample_pointclouds, downsample_rgbdimages
from ..odometry.projective import pack_frame_geom, projective_associate
from ..ops import nn_points_auto
from ..structures.pointclouds import Pointclouds, compact_masked, gather_rows
from ..structures.rgbdimages import RGBDImages
from .fusionutils import find_active_map_points

__all__ = ["tracking_health", "keyframe_anchor"]

# A source with no admissible target comes back from the 1-NN as
# (1e30, 0): its "neighbour" is a padding row whose zero normal makes the
# residual exactly 0, a false perfect inlier. Admissibility is decided by a
# finite distance, never by the index.
_FINITE_DIST = 1e29


def keyframe_anchor(live_frame: RGBDImages, dsratio: int = 1) -> Pointclouds:
    r"""A geometry-only world-frame snapshot (points and normals) of a
    sequence-length-1 frame at its solved pose: a frozen reference against
    which :func:`tracking_health` exposes slow drift that the self-fused map
    cannot. Rows with a zero normal are dropped (their plane residual is 0
    at any pose). Keep ``dsratio`` at 1 unless the health calls use a
    matching finer stride: the 1-NN health strides the map side by the
    current pixel lattice, and a pre-strided anchor aliases against it."""
    pc = downsample_rgbdimages(live_frame, dsratio)
    solid = pc.nonpad_mask & (torch.sum(pc.normals * pc.normals, dim=-1) > 0.0)
    cap = pc.points.shape[1]
    pts, cnt = compact_masked(pc.points, solid, cap)
    nrm, _ = compact_masked(pc.normals, solid, cap)
    return Pointclouds(points=pts, num_points=cnt, normals=nrm)


def tracking_health(
    pointclouds: Pointclouds,
    live_frame: RGBDImages,
    *,
    dsratio: int = 4,
    robust_scale: float = 0.05,
    dist_thresh: Optional[float] = None,
    icp_capacity: Optional[int] = None,
    method: str = "knn",
) -> Dict[str, torch.Tensor]:
    r"""Frame-to-map tracking health at the frame's current pose.

    Args:
        pointclouds: the map (with normals).
        live_frame: sequence-length-1 frame whose ``poses`` hold the pose
            under test.
        dsratio, dist_thresh, icp_capacity: association controls (use the
            pipeline's, so that health measures the solver's own view).
        robust_scale: the inlier band (metres).
        method: ``'knn'`` (the 1-NN association of the classic solvers) or
            ``'projective'`` (the projective association; its rows are the
            map window's, not the frame's).

    Returns:
        dict of ``(B,)`` float tensors: ``inlier_frac`` (admissible rows with
        a residual within ``robust_scale``), ``assoc_frac`` (admissible
        rows), ``median_abs_residual`` over admissible rows (NaN when there
        are none) and ``overlap_frac`` (map points in the frame's frustum).
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
            "tracking_health needs map normals (point-to-plane residuals); the map has none."
        )
    if live_frame.poses is None:
        raise ValueError("live_frame must carry poses (the pose under test).")
    if method not in ("knn", "projective"):
        raise ValueError(f"Unknown method: {method!r}. Expected 'knn' or 'projective'.")
    health = _projective_health if method == "projective" else _association_health
    return health(pointclouds, live_frame, dsratio=dsratio, robust_scale=robust_scale,
                  dist_thresh=dist_thresh, icp_capacity=icp_capacity)


def _nanmedian(r: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """Median of ``r (B, N)`` over the rows where ``keep``, NaN where none:
    ``jnp.nanmedian``'s linear interpolation between the two middle values
    (``torch.nanmedian`` takes the lower one)."""
    n = keep.sum(dim=-1)
    srt = torch.sort(torch.where(keep, r, torch.full_like(r, math.inf)), dim=-1).values
    q = 0.5 * (n.to(r.dtype) - 1.0)
    lo, hi = torch.floor(q), torch.ceil(q)
    w_hi = q - lo
    last = r.shape[-1] - 1

    def at(i):
        return torch.gather(srt, 1, torch.clamp(i, 0, max(last, 0)).long()[:, None])[:, 0]

    if last < 0:
        return torch.full(r.shape[:1], math.nan, dtype=r.dtype, device=r.device)
    med = at(lo) * (1.0 - w_hi) + at(hi) * w_hi
    return torch.where(n > 0, med, torch.full_like(med, math.nan))


def _knn_rows(frames_pc: Pointclouds, maps_pc: Pointclouds, dist_thresh: Optional[float]):
    """The 1-NN association of the frame cloud with the map cloud:
    ``(admissible (B, N), residual (B, N), n_src (B,))``."""
    src, src_mask = frames_pc.points, frames_pc.nonpad_mask
    dists, idx = nn_points_auto(src, maps_pc.points, maps_pc.nonpad_mask)
    admissible = src_mask & (dists < _FINITE_DIST)
    if dist_thresh is not None:
        admissible = admissible & (dists < dist_thresh)
    d = gather_rows(maps_pc.points, idx)
    n = gather_rows(maps_pc.normals, idx)
    r = torch.abs(torch.sum(n * (d - src), dim=-1))
    n_src = torch.clamp(src_mask.sum(dim=-1).to(src.dtype), min=1.0)
    return admissible, r, n_src


def _fraction(mask: torch.Tensor, denom: torch.Tensor) -> torch.Tensor:
    return mask.sum(dim=-1).to(denom.dtype) / denom


def _map_window(pointclouds: Pointclouds, live_frame: RGBDImages, dsratio: int,
                icp_capacity: Optional[int]):
    """The frame's view of the map: the active points on the stride-``ds``
    pixel lattice, compacted (``downsample_pointclouds``). Returns the window
    and the active mask."""
    _, _, H, W = live_frame.shape
    target = Pointclouds(points=pointclouds.points, num_points=pointclouds.num_points,
                         normals=pointclouds.normals)
    active = find_active_map_points(target, live_frame)
    cap = (icp_capacity if icp_capacity is not None
           else 2 * math.ceil(H / dsratio) * math.ceil(W / dsratio))
    window = downsample_pointclouds(target, active.valid, active.pix_h, active.pix_w,
                                    dsratio, cap)
    return window, active.valid


def _overlap(active_valid: torch.Tensor, pointclouds: Pointclouds) -> torch.Tensor:
    return active_valid.sum(dim=-1).to(pointclouds.points.dtype) / torch.clamp(
        pointclouds.num_points.to(pointclouds.points.dtype), min=1.0)


def _association_health(
    pointclouds: Pointclouds,
    live_frame: RGBDImages,
    *,
    dsratio: int,
    robust_scale: float,
    dist_thresh: Optional[float],
    icp_capacity: Optional[int],
) -> Dict[str, torch.Tensor]:
    """The 1-NN form of :func:`tracking_health`, without its checks (also
    scores the relocalization hypotheses): the stride-``ds`` frame cloud
    against the frame's stride-``ds`` view of the map."""
    maps_pc, active_valid = _map_window(pointclouds, live_frame, dsratio, icp_capacity)
    frames_pc = downsample_rgbdimages(live_frame, dsratio)
    admissible, r, n_src = _knn_rows(frames_pc, maps_pc, dist_thresh)
    return {
        "inlier_frac": _fraction(admissible & (r <= robust_scale), n_src),
        "assoc_frac": _fraction(admissible, n_src),
        "median_abs_residual": _nanmedian(r, admissible),
        "overlap_frac": _overlap(active_valid, pointclouds),
    }


def _window_health_knn(
    frames_pc: Pointclouds,
    maps_pc: Pointclouds,
    *,
    robust_scale: float,
    dist_thresh: Optional[float],
) -> torch.Tensor:
    """``inlier_frac`` of :func:`_association_health` against a map window
    already compacted (the odometry's own finest window): the in-scan gate's
    healthy path, one 1-NN launch and no pass over the map."""
    admissible, r, n_src = _knn_rows(frames_pc, maps_pc, dist_thresh)
    return _fraction(admissible & (r <= robust_scale), n_src)


def _projective_rows(maps_pc: Pointclouds, frame_geom, intrinsics, poses, H: int, W: int,
                     dist_thresh: Optional[float]):
    """The projective association of the map window with the packed frame:
    ``(admissible (B, N), residual (B, N), n_rows (B,))``."""
    m_pts, m_nrm, m_mask = maps_pc.points, maps_pc.normals, maps_pc.nonpad_mask
    s, admissible, _ = projective_associate(
        m_pts, m_nrm, m_mask, frame_geom, intrinsics, poses, H, W, dist_thresh)
    r = torch.abs(torch.sum(m_nrm * (m_pts - s), dim=-1))
    n_rows = torch.clamp(m_mask.sum(dim=-1).to(m_pts.dtype), min=1.0)
    return admissible, r, n_rows


def _window_health_projective(
    maps_pc: Pointclouds,
    frame_geom: torch.Tensor,  # (B, H*W, 8)
    intrinsics: torch.Tensor,  # (B, 4, 4)
    poses: torch.Tensor,  # (B, 4, 4), the pose under test
    H: int,
    W: int,
    *,
    robust_scale: float,
    dist_thresh: Optional[float],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(inlier_frac, assoc_frac)`` of the projective association over a
    compacted map window: one projection and one row gather. Rows with a
    zero normal carry no plane and are not admissible (their residual is 0
    at any pose). ``assoc_frac`` near 0 says the window left the view."""
    admissible, r, n_rows = _projective_rows(maps_pc, frame_geom, intrinsics, poses, H, W,
                                             dist_thresh)
    m_nrm = maps_pc.normals
    admissible = admissible & (torch.sum(m_nrm * m_nrm, dim=-1) > 0.0)
    return (_fraction(admissible & (r <= robust_scale), n_rows),
            _fraction(admissible, n_rows))


def _projective_health(
    pointclouds: Pointclouds,
    live_frame: RGBDImages,
    *,
    dsratio: int,
    robust_scale: float,
    dist_thresh: Optional[float],
    icp_capacity: Optional[int],
) -> Dict[str, torch.Tensor]:
    """The projective form of :func:`tracking_health`, without its checks:
    the frame's stride-``ds`` view of the map associated by projection into
    the packed frame; no 1-NN search. Rows are the window's."""
    _, _, H, W = live_frame.shape
    maps_pc, active_valid = _map_window(pointclouds, live_frame, dsratio, icp_capacity)
    admissible, r, n_rows = _projective_rows(
        maps_pc, pack_frame_geom(live_frame), live_frame.intrinsics[:, 0],
        live_frame.poses[:, 0], H, W, dist_thresh)
    return {
        "inlier_frac": _fraction(admissible & (r <= robust_scale), n_rows),
        "assoc_frac": _fraction(admissible, n_rows),
        "median_abs_residual": _nanmedian(r, admissible),
        "overlap_frac": _overlap(active_valid, pointclouds),
    }
