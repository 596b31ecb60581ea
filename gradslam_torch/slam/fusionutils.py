r"""Point-based map fusion (Keller et al. "PointFusion"), PyTorch.

Counterpart of ``gradslam_tpu/slam/fusionutils.py``: ``get_alpha`` (:84),
``find_active_map_points`` (:137), ``_project_map_points`` (:360) and
``update_map_fusion`` (:405) with the ``sort_full`` association and the
``gather`` merge on a float-color map. Every stage is a dense masked
computation over the fixed-capacity map buffer:

1. a streaming projection of all map rows into the live frame;
2. gating of each row against the frame pixel it lands on;
3. one winner per pixel by the lexicographic order
   ``(pixel, -ccount, raydist, index)``;
4. a confidence-weighted merge of winners and an append of un-corresponded
   valid pixels, written back by rebuilding the map by gather.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Union

import torch

from ..geometry.geometryutils import inverse_transformation, transform_pointcloud
from ..geometry.projutils import project_points
from ..structures.pointclouds import Pointclouds, gather_rows, scatter_rows
from ..structures.rgbdimages import RGBDImages

__all__ = [
    "ActiveMapPoints",
    "get_alpha",
    "find_active_map_points",
    "update_map_fusion",
]


def get_alpha(
    points: torch.Tensor,
    sigma: Union[float, torch.Tensor],
    dim: int = -1,
    keepdim: bool = False,
    eps: float = 1e-7,
) -> torch.Tensor:
    r"""Sample confidence ``exp(-||p||^2 / (2 sigma^2))`` clamped to
    ``[eps, 1.01]`` (the 1.01 clamp is the reference's and is kept)."""
    if points.shape[dim] != 3:
        raise ValueError(
            f"Expected length of dim-th ({dim}th) dimension to be 3. "
            f"Got {points.shape[dim]} instead."
        )
    alpha = torch.exp(-torch.sum(points**2, dim=dim, keepdim=keepdim) / (2 * sigma**2))
    return torch.clamp(alpha, eps, 1.01)


class ActiveMapPoints(NamedTuple):
    r"""Per-map-point projection into a live frame."""

    valid: torch.Tensor  # (B, CAP) bool: lands inside the frame
    pix_h: torch.Tensor  # (B, CAP) int64: row (clamped)
    pix_w: torch.Tensor  # (B, CAP) int64: column (clamped)


def _snap(coord: torch.Tensor, size: int) -> torch.Tensor:
    # torch.round is round-half-to-even, as jnp.round
    return torch.clamp(torch.round(coord), 0, size - 1).to(torch.int64)


def find_active_map_points(
    pointclouds: Pointclouds, rgbdimages: RGBDImages
) -> ActiveMapPoints:
    r"""Project all map points into the live frame and mark those landing
    inside it: in front of the camera, within bounds, not padding."""
    if rgbdimages.shape[1] != 1:
        raise ValueError(
            f"Expected rgbdimages to have sequence length of 1. Got {rgbdimages.shape[1]}."
        )
    if len(rgbdimages) != len(pointclouds):
        raise ValueError(
            "Expected equal batch sizes for pointclouds and rgbdimages. "
            f"Got {len(pointclouds)} and {len(rgbdimages)} respectively."
        )
    _, _, H, W = rgbdimages.shape
    tinv = inverse_transformation(rgbdimages.poses[:, 0])
    cam_pts = transform_pointcloud(pointclouds.points, tinv)
    img_pts = project_points(cam_pts, rgbdimages.intrinsics[:, 0])
    u, v = img_pts[..., 0], img_pts[..., 1]
    valid = (
        (u > -1e-3)
        & (u < W - 0.999)
        & (v > -1e-3)
        & (v < H - 0.999)
        & (cam_pts[..., 2] > 0)
        & pointclouds.nonpad_mask
    )
    return ActiveMapPoints(valid=valid, pix_h=_snap(v, H), pix_w=_snap(u, W))


def _project_map_points(points, nonpad_mask, pose, intrinsics, H: int, W: int):
    r"""Elementwise projection of all map points into a frame: ``cam =
    R^T (p - t)``, pinhole projection with the z == 0 guard, the reference's
    bounds test and round-half-to-even snap. Returns ``(valid (B, CAP),
    pix (B, CAP) int64 = h * W + w)``."""
    R = pose[:, :3, :3]
    t = pose[:, :3, 3]
    rx = points[..., 0] - t[:, None, 0]
    ry = points[..., 1] - t[:, None, 1]
    rz = points[..., 2] - t[:, None, 2]

    def col(j):
        return R[:, 0, j][:, None] * rx + R[:, 1, j][:, None] * ry + R[:, 2, j][:, None] * rz

    x, y, z = col(0), col(1), col(2)
    fx = intrinsics[:, 0, 0][:, None]
    fy = intrinsics[:, 1, 1][:, None]
    cx = intrinsics[:, 0, 2][:, None]
    cy = intrinsics[:, 1, 2][:, None]
    zg = torch.where(z == 0, torch.ones_like(z), z)
    u = fx * (x / zg) + cx
    v = fy * (y / zg) + cy
    valid = (
        (u > -1e-3)
        & (u < W - 0.999)
        & (v > -1e-3)
        & (v < H - 0.999)
        & (z > 0)
        & nonpad_mask
    )
    return valid, _snap(v, H) * W + _snap(u, W)


def _lexsort(keys) -> torch.Tensor:
    r"""Permutation ``(B, N)`` sorting each row by ``keys`` (most significant
    LAST), ties broken by the row's original index: stable sorts from the
    least significant key up."""
    order = None
    for key in keys:
        k = key if order is None else torch.gather(key, 1, order)
        perm = torch.sort(k, dim=1, stable=True).indices
        order = perm if order is None else torch.gather(order, 1, perm)
    return order


def update_map_fusion(
    pointclouds: Pointclouds,
    rgbdimages: RGBDImages,
    dist_th: Union[float, int],
    dot_th: Union[float, int],
    sigma: Union[float, int, torch.Tensor],
    association: str = "auto",
    merge: str = "auto",
) -> Pointclouds:
    r"""One PointFusion map update from a live frame.

    ``association``: ``'sort_full'`` gates and sorts every map row (exact:
    no window overflow); ``'auto'`` resolves to it. ``merge``: ``'gather'``
    rebuilds the map by gather; ``'auto'`` resolves to it. The JAX package's
    ``'windowed'`` and ``'scatter'`` modes are not ported yet (ROADMAP.md
    queue 1, item 1); they would give the same map as these two whenever the
    window does not overflow.
    """
    for name, mode, ported, other in (
        ("association", association, "sort_full", "windowed"),
        ("merge", merge, "gather", "scatter"),
    ):
        if mode == other:
            raise NotImplementedError(
                f"update_map_fusion({name}={other!r}) is not ported yet "
                "(ROADMAP.md queue 1, item 1); use 'auto' or "
                f"{ported!r}."
            )
        if mode not in ("auto", ported):
            raise ValueError(f"Unknown {name} mode: {mode!r}")
    if rgbdimages.shape[1] != 1:
        raise ValueError(
            f"Expected rgbdimages to have sequence length of 1. Got {rgbdimages.shape[1]}."
        )
    if rgbdimages.poses is None:
        raise ValueError("rgbdimages must have poses for map fusion.")
    if pointclouds.normals is None or pointclouds.features is None:
        raise ValueError(
            "update_map_fusion needs a map with normals and features "
            "(ccounts): use the pipeline's empty_map() to build one."
        )
    if pointclouds.colors is None or pointclouds.features.shape[-1] != 1:
        raise NotImplementedError(
            "update_map_fusion supports the float-color map with one ccount "
            "feature channel; the quantized-color layout and user feature "
            "channels are not ported yet (ROADMAP.md queue 1, item 8)."
        )
    B, _, H, W = rgbdimages.shape
    cap = pointclouds.capacity
    HW = H * W
    device = pointclouds.points.device
    points, normals, colors = pointclouds.points, pointclouds.normals, pointclouds.colors
    ccount = pointclouds.features

    # --- 1. streaming projection over the full map -----------------------
    valid, pix = _project_map_points(
        points, pointclouds.nonpad_mask, rgbdimages.poses[:, 0],
        rgbdimages.intrinsics[:, 0], H, W,
    )
    vertex_flat = rgbdimages.global_vertex_map.reshape(B, HW, 3)
    normal_flat = rgbdimages.global_normal_map.reshape(B, HW, 3)

    # --- 2. gating against the frame pixel each map row lands on ---------
    safe_pix = torch.clamp(pix, max=HW - 1)
    fp = gather_rows(vertex_flat, safe_pix)
    fn = gather_rows(normal_flat, safe_pix)
    is_close = torch.linalg.norm(fp - points, dim=-1) < dist_th
    is_similar = torch.sum(fn * normals, dim=-1) > dot_th
    eligible = valid & is_close & is_similar

    # --- 3. per-pixel winner by (pixel, -ccount, raydist, index) ---------
    inf = torch.full((), float("inf"), dtype=points.dtype, device=device)
    ray_dists = torch.sum((points - fp) ** 2, dim=-1)
    k_pix = torch.where(eligible, pix, torch.full_like(pix, HW))  # ineligible last
    k_negcc = torch.where(eligible, -ccount[..., 0], inf)
    k_ray = torch.where(eligible, ray_dists, inf)
    order = _lexsort([k_ray, k_negcc, k_pix])  # row index is the implicit last key
    s_pix = torch.gather(k_pix, 1, order)
    first = torch.ones_like(s_pix, dtype=torch.bool)
    first[:, 1:] = s_pix[:, 1:] != s_pix[:, :-1]
    s_winner = first & (s_pix < HW)

    # per-pixel winner map row (cap = "no winner"); losers park at HW + i
    park = HW + torch.arange(cap, device=device)[None, :]
    winner_row = scatter_rows(HW, torch.where(s_winner, s_pix, park), order, fill=cap)
    corresponded = winner_row < cap
    safe_row = torch.clamp(winner_row, max=cap - 1)

    # --- 4. confidence-weighted merge + append, in pixel space -----------
    color_flat = rgbdimages.rgb_image.reshape(B, HW, 3)
    alpha = get_alpha(rgbdimages.vertex_map, sigma=sigma, dim=4, keepdim=True)
    alpha_flat = alpha.reshape(B, HW, 1)
    m_row = gather_rows(torch.cat([points, normals, ccount, colors], dim=-1), safe_row)
    m_pts, m_nrm, m_cc, m_col = m_row[..., :3], m_row[..., 3:6], m_row[..., 6:7], m_row[..., 7:]

    corr = corresponded[..., None]
    cc_old = torch.where(corr, m_cc, torch.zeros_like(m_cc))  # new points start at zero mass
    new_cc = cc_old + alpha_flat
    inv_cc = 1.0 / torch.where(new_cc == 0, torch.ones_like(new_cc), new_cc)
    out_pts = (cc_old * m_pts + alpha_flat * vertex_flat) * inv_cc
    out_nrm = (cc_old * m_nrm + alpha_flat * normal_flat) * inv_cc
    out_col = (cc_old * m_col + alpha_flat * color_flat) * inv_cc

    # destination row per pixel: the winner row for merges, a fresh tail slot
    # for appends, a unique trash slot cap + i otherwise
    valid_depth = rgbdimages.valid_depth_mask.reshape(B, HW)
    new_mask = valid_depth & ~corresponded
    tail = pointclouds.num_points[:, None] + torch.cumsum(new_mask.to(torch.int64), dim=-1) - 1
    appends = new_mask & (tail < cap)
    trash = cap + torch.arange(HW, device=device)[None, :]
    dest = torch.where(corresponded, winner_row, torch.where(appends, tail, trash))
    appended = appends.sum(dim=-1)
    num_dropped = pointclouds.num_dropped
    if num_dropped is not None:
        num_dropped = num_dropped + (new_mask.sum(dim=-1) - appended)

    # --- 5. rebuild by gather: invert pixel -> row, then every row gathers
    pix_ids = torch.arange(HW, device=device)[None, :].expand(B, HW)
    row_src = scatter_rows(cap, dest, pix_ids, fill=HW)
    touched = (row_src < HW)[..., None]
    g = gather_rows(
        torch.cat([out_pts, out_nrm, new_cc, out_col], dim=-1),
        torch.where(row_src < HW, row_src, torch.zeros_like(row_src)),
    )
    return dataclasses.replace(
        pointclouds,
        points=torch.where(touched, g[..., :3], points),
        normals=torch.where(touched, g[..., 3:6], normals),
        features=torch.where(touched, g[..., 6:7], ccount),
        colors=torch.where(touched, g[..., 7:], colors),
        num_points=pointclouds.num_points + appended,
        num_dropped=num_dropped,
    )
