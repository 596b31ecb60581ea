r"""Point-based map fusion (Keller et al. "PointFusion"), PyTorch.

Counterpart of ``gradslam_tpu/slam/fusionutils.py``: ``pack_colors`` and
``unpack_colors`` (:59-81), ``get_alpha`` (:84), ``find_active_map_points``
(:137), ``_project_map_points`` (:360), ``update_map_fusion`` (:405) with
both associations (``sort_full``, ``windowed``), both merges (``gather``,
``scatter``) and both map layouts (float colors, quantized colors),
``update_map_aggregate`` (:771, ``ICPSLAM``'s aggregate map) and
``prune_map`` (:827). Every fusion stage is a dense masked computation over
the fixed-capacity map buffer:

1. a streaming projection of all map rows into the live frame;
2. optionally, a compaction of the rows that land in the frame into a
   fixed window;
3. gating of each candidate against the frame pixel it lands on;
4. one winner per pixel by the lexicographic order
   ``(pixel, -ccount, raydist, map row)``;
5. a confidence-weighted merge of winners and an append of un-corresponded
   valid pixels, written back by gather or by scatter.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Union

import torch

from ..geometry.geometryutils import inverse_transformation, transform_pointcloud
from ..geometry.projutils import project_points
from ..structures.pointclouds import (
    Pointclouds,
    compact_masked,
    gather_rows,
    scatter_rows,
    scatter_rows_into,
)
from ..structures.rgbdimages import RGBDImages

__all__ = [
    "ActiveMapPoints",
    "get_alpha",
    "find_active_map_points",
    "pack_colors",
    "prune_map",
    "unpack_colors",
    "update_map_aggregate",
    "update_map_fusion",
]


def pack_colors(colors: torch.Tensor) -> torch.Tensor:
    r"""Quantize float colors ``(..., 3)`` in [0, 1] to 8 bits a channel
    (round half to even, as ``jnp.round``) and pack them into one float32
    channel ``(..., 1)`` holding the integer ``r << 16 | g << 8 | b``, which
    float32 holds exactly (at most 2^24 - 1)."""
    q = torch.clamp(torch.round(colors * 255.0), 0, 255).to(torch.int32)
    packed = (q[..., 0] << 16) | (q[..., 1] << 8) | q[..., 2]
    return packed.to(torch.float32)[..., None]


def unpack_colors(packed: torch.Tensor) -> torch.Tensor:
    r"""Inverse of :func:`pack_colors`: ``(..., 1)`` to float colors
    ``(..., 3)`` in [0, 1]."""
    p = packed[..., 0].to(torch.int32)
    rgb = torch.stack([(p >> 16) & 0xFF, (p >> 8) & 0xFF, p & 0xFF], dim=-1)
    return rgb.to(torch.float32) / 255.0


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


def _resolve_modes(association: str, merge: str, cap: int, HW: int, window: int):
    """``'auto'`` exactly as the JAX package resolves it
    (``gradslam_tpu/slam/fusionutils.py:501-509``)."""
    if association == "auto":
        association = "sort_full" if cap <= max(3 * HW, window) else "windowed"
    if association not in ("sort_full", "windowed"):
        raise ValueError(f"Unknown association mode: {association!r}")
    if merge == "auto":
        merge = "gather" if cap <= 6 * HW else "scatter"
    if merge not in ("scatter", "gather"):
        raise ValueError(f"Unknown merge mode: {merge!r}")
    return association, merge


def update_map_fusion(
    pointclouds: Pointclouds,
    rgbdimages: RGBDImages,
    dist_th: Union[float, int],
    dot_th: Union[float, int],
    sigma: Union[float, int, torch.Tensor],
    active_capacity: Optional[int] = None,
    association: str = "auto",
    merge: str = "auto",
) -> Pointclouds:
    r"""One PointFusion map update from a live frame.

    ``association``: ``'sort_full'`` gates and sorts every map row (exact:
    nothing overflows); ``'windowed'`` first compacts the rows that land in
    the frame into a window of ``active_capacity`` rows (default
    ``2 * H * W``), and rows past the window are left unmerged for this
    frame; ``'auto'`` picks ``'windowed'`` when the capacity exceeds
    ``max(3 * H * W, window)``. ``merge``: ``'gather'`` rebuilds the map by
    gather, ``'scatter'`` writes the pixel rows into the map buffers; both
    give the same map, and ``'auto'`` picks ``'gather'`` up to
    ``6 * H * W`` rows. ``'auto'`` resolves exactly as in the JAX package.

    The map is either float-color (``colors (B, CAP, 3)``, features
    ``[ccount]``) or quantized (``colors=None``, features ``[ccount,
    packed_color]``, see :func:`pack_colors`).
    """
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
    quantized = pointclouds.colors is None
    base = 2 if quantized else 1
    if pointclouds.features.shape[-1] != base:
        raise NotImplementedError(
            "update_map_fusion supports the float-color map ([ccount]) and the "
            "quantized map ([ccount, packed_color]); user feature channels are "
            "not ported yet (ROADMAP.md queue 1, item 8)."
        )
    B, _, H, W = rgbdimages.shape
    cap = pointclouds.capacity
    HW = H * W
    device = pointclouds.points.device
    window = min(active_capacity if active_capacity is not None else 2 * HW, cap)
    association, merge = _resolve_modes(association, merge, cap, HW, window)
    pose = rgbdimages.poses[:, 0]
    K = rgbdimages.intrinsics[:, 0]
    points, normals, feats = pointclouds.points, pointclouds.normals, pointclouds.features
    # one packed row per map point: points | normals | ccount | packed color
    # (quantized) or float color
    map_row = torch.cat(
        [points, normals, feats] + ([] if quantized else [pointclouds.colors]), dim=-1
    )

    # --- 1. streaming projection over the full map -----------------------
    valid, pix = _project_map_points(points, pointclouds.nonpad_mask, pose, K, H, W)
    vertex_flat = rgbdimages.global_vertex_map.reshape(B, HW, 3)
    normal_flat = rgbdimages.global_normal_map.reshape(B, HW, 3)

    # --- 2. candidates (width N): pixel, map row, geometry ---------------
    if association == "sort_full":
        cand_valid, cand_pix = valid, pix
        cand_idx = None  # the candidate's position is its map row
        c_pts, c_nrm, c_cc = points, normals, feats[..., 0]
    else:
        # compact the rows that land in the frame into the window, in row
        # order; rows past the window are dropped
        N = window
        rank = torch.cumsum(valid.to(torch.int64), dim=-1) - 1
        dest = torch.where(valid, rank, torch.full_like(rank, -1))
        row_ids = torch.arange(cap, device=device)[None, :].expand(B, cap)
        cand_idx = scatter_rows(N, dest, row_ids)
        num_active = torch.clamp(valid.sum(dim=-1), max=N)
        cand_valid = torch.arange(N, device=device)[None, :] < num_active[:, None]
        w_row = gather_rows(map_row[..., :7], cand_idx)
        c_pts, c_nrm, c_cc = w_row[..., :3], w_row[..., 3:6], w_row[..., 6]
        # each candidate's pixel from its gathered position, as in JAX
        _, cand_pix = _project_map_points(c_pts, cand_valid, pose, K, H, W)

    # --- 3. gating against the frame pixel each candidate lands on -------
    safe_pix = torch.clamp(cand_pix, max=HW - 1)
    fp = gather_rows(vertex_flat, safe_pix)
    fn = gather_rows(normal_flat, safe_pix)
    is_close = torch.linalg.norm(fp - c_pts, dim=-1) < dist_th
    is_similar = torch.sum(fn * c_nrm, dim=-1) > dot_th
    eligible = cand_valid & is_close & is_similar

    # --- 4. per-pixel winner by (pixel, -ccount, raydist, map row) -------
    # Window candidates are in map-row order, so the candidate's position
    # breaks ties as the map row does.
    inf = torch.full((), float("inf"), dtype=points.dtype, device=device)
    ray_dists = torch.sum((c_pts - fp) ** 2, dim=-1)
    k_pix = torch.where(eligible, cand_pix, torch.full_like(cand_pix, HW))  # ineligible last
    k_negcc = torch.where(eligible, -c_cc, inf)
    k_ray = torch.where(eligible, ray_dists, inf)
    order = _lexsort([k_ray, k_negcc, k_pix])  # position is the implicit last key
    s_pix = torch.gather(k_pix, 1, order)
    s_idx = order if cand_idx is None else torch.gather(cand_idx, 1, order)
    first = torch.ones_like(s_pix, dtype=torch.bool)
    first[:, 1:] = s_pix[:, 1:] != s_pix[:, :-1]
    s_winner = first & (s_pix < HW)

    # per-pixel winner map row (cap = "no winner"); losers are dropped
    winner_row = scatter_rows(HW, torch.where(s_winner, s_pix, torch.full_like(s_pix, -1)),
                              s_idx, fill=cap)
    corresponded = winner_row < cap
    safe_row = torch.clamp(winner_row, max=cap - 1)

    # --- 5. confidence-weighted merge + append, in pixel space -----------
    color_flat = rgbdimages.rgb_image.reshape(B, HW, 3)
    alpha = get_alpha(rgbdimages.vertex_map, sigma=sigma, dim=4, keepdim=True)
    alpha_flat = alpha.reshape(B, HW, 1)
    m_row = gather_rows(map_row, safe_row)
    m_pts, m_nrm, m_cc = m_row[..., :3], m_row[..., 3:6], m_row[..., 6:7]
    m_col = unpack_colors(m_row[..., 7:8]) if quantized else m_row[..., 7:]

    corr = corresponded[..., None]
    cc_old = torch.where(corr, m_cc, torch.zeros_like(m_cc))  # new points start at zero mass
    new_cc = cc_old + alpha_flat
    inv_cc = 1.0 / torch.where(new_cc == 0, torch.ones_like(new_cc), new_cc)
    out_pts = (cc_old * m_pts + alpha_flat * vertex_flat) * inv_cc
    out_nrm = (cc_old * m_nrm + alpha_flat * normal_flat) * inv_cc
    out_col = (cc_old * m_col + alpha_flat * color_flat) * inv_cc
    out_row = torch.cat(
        [out_pts, out_nrm, new_cc, pack_colors(out_col) if quantized else out_col], dim=-1
    )

    # destination row per pixel: the winner row for merges, a fresh tail slot
    # for appends, -1 (dropped) otherwise
    valid_depth = rgbdimages.valid_depth_mask.reshape(B, HW)
    new_mask = valid_depth & ~corresponded
    tail = pointclouds.num_points[:, None] + torch.cumsum(new_mask.to(torch.int64), dim=-1) - 1
    appends = new_mask & (tail < cap)
    dest = torch.where(corresponded, winner_row,
                       torch.where(appends, tail, torch.full_like(tail, -1)))
    appended = appends.sum(dim=-1)
    num_dropped = pointclouds.num_dropped
    if num_dropped is not None:
        num_dropped = num_dropped + (new_mask.sum(dim=-1) - appended)

    # --- 6. write-back ---------------------------------------------------
    if merge == "gather":
        # invert pixel -> row, then every map row gathers its new value
        pix_ids = torch.arange(HW, device=device)[None, :].expand(B, HW)
        row_src = scatter_rows(cap, dest, pix_ids, fill=HW)
        touched = row_src < HW
        g = gather_rows(out_row, torch.where(touched, row_src, torch.zeros_like(row_src)))
        new_row = torch.where(touched[..., None], g, map_row)
    else:
        # write the pixel rows over the map rows (rows marked -1 dropped)
        new_row = scatter_rows_into(map_row, dest, out_row)
    f_end = 6 + base
    return dataclasses.replace(
        pointclouds,
        points=new_row[..., :3].contiguous(),
        normals=new_row[..., 3:6].contiguous(),
        features=new_row[..., 6:f_end].contiguous(),
        colors=None if quantized else new_row[..., f_end:].contiguous(),
        num_points=pointclouds.num_points + appended,
        num_dropped=num_dropped,
    )


def update_map_aggregate(
    pointclouds: Pointclouds,
    rgbdimages: RGBDImages,
    sigma: Optional[Union[float, int]] = None,
) -> Pointclouds:
    r"""Naive aggregation: append every valid-depth pixel of the live frame
    (global vertex, global normal, color) to the map, in pixel order
    (:meth:`Pointclouds.append_masked`). A map with a features buffer gets
    each point's confidence ``get_alpha`` (``sigma`` 0.6 by default) there;
    user feature channels after it are not ported yet."""
    if not isinstance(pointclouds, Pointclouds):
        raise TypeError(f"Expected pointclouds to be of type Pointclouds. Got {type(pointclouds)}.")
    if not isinstance(rgbdimages, RGBDImages):
        raise TypeError(f"Expected rgbdimages to be of type RGBDImages. Got {type(rgbdimages)}.")
    B, _, H, W = rgbdimages.shape
    features = None
    if pointclouds.features is not None:
        if pointclouds.features.shape[-1] != 1:
            raise NotImplementedError(
                "update_map_aggregate supports no user feature channels yet "
                "(ROADMAP.md queue 1, item 8)."
            )
        alpha = get_alpha(rgbdimages.vertex_map, sigma=0.6 if sigma is None else sigma,
                          dim=4, keepdim=True)
        features = alpha.reshape(B, H * W, 1)
    return pointclouds.append_masked(
        rgbdimages.global_vertex_map.reshape(B, H * W, 3),
        rgbdimages.valid_depth_mask.reshape(B, H * W),
        normals=(rgbdimages.global_normal_map.reshape(B, H * W, 3)
                 if pointclouds.normals is not None else None),
        colors=(rgbdimages.rgb_image.reshape(B, H * W, 3)
                if pointclouds.colors is not None else None),
        features=features,
    )


def prune_map(pointclouds: Pointclouds, min_confidence: Union[float, int]) -> Pointclouds:
    r"""Remove unstable map points, those whose confidence (features channel
    0) is below ``min_confidence``, and pack the survivors to the front in
    order (Keller et al.'s map maintenance; ``gradslam_tpu/slam/
    fusionutils.py:827``). ``num_dropped`` carries over."""
    if pointclouds.features is None:
        raise ValueError("Pointclouds must have features (ccounts) to prune.")
    keep = pointclouds.nonpad_mask & (pointclouds.features[..., 0] >= min_confidence)
    bufs = [b for b in (pointclouds.points, pointclouds.normals, pointclouds.colors,
                        pointclouds.features) if b is not None]
    packed, counts = compact_masked(torch.cat(bufs, dim=-1), keep, pointclouds.capacity)
    parts = iter(torch.split(packed, [b.shape[-1] for b in bufs], dim=-1))

    def part(buf):
        return None if buf is None else next(parts).contiguous()

    return Pointclouds(
        points=part(pointclouds.points),
        num_points=counts,
        normals=part(pointclouds.normals),
        colors=part(pointclouds.colors),
        features=part(pointclouds.features),
        num_dropped=pointclouds.num_dropped,
    )
