r"""Point-based map fusion (Keller et al. "PointFusion"), PyTorch.

Counterpart of ``gradslam_tpu/slam/fusionutils.py``: ``pack_colors`` and
``unpack_colors`` (:59-81), ``get_alpha`` (:84), ``find_active_map_points``
(:137), ``_project_map_points`` (:360), ``update_map_fusion`` (:405) with
both associations (``sort_full``, ``windowed``), both merges (``gather``,
``scatter``) and both map layouts (float colors, quantized colors),
``update_map_aggregate`` (:771, ``ICPSLAM``'s aggregate map),
``prune_map`` (:827) and ``voxel_downsample`` (:860), each with user feature
channels after the map's bookkeeping channels (``PointFusion(
feature_channels=F)``: semantic one-hots, descriptors); and the dense
reference path ``find_correspondences`` + ``fuse_with_map`` (:104-357), the
reference gradslam's own algorithm, which no pipeline option selects: it
is the oracle the fast path is held against. Every fusion stage of the fast
path is a dense masked computation over the fixed-capacity map buffer:

1. a streaming projection of all map rows into the live frame;
2. optionally, a compaction of the rows that land in the frame into a
   fixed window;
3. gating of each candidate against the frame pixel it lands on;
4. one winner per pixel by the lexicographic order
   ``(pixel, -ccount, raydist, map row)``;
5. a confidence-weighted merge of winners and an append of un-corresponded
   valid pixels, written back by gather or by scatter.

User feature channels never enter a merge decision: a map fused with
features has the geometry, colors and confidences of the same map fused
without them, bit for bit.
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
    "are_normals_similar",
    "are_points_close",
    "find_best_unique_correspondences",
    "find_correspondences",
    "find_similar_map_points",
    "fuse_with_map",
    "get_alpha",
    "find_active_map_points",
    "pack_colors",
    "prune_map",
    "unpack_colors",
    "update_map_aggregate",
    "update_map_fusion",
    "voxel_downsample",
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


def _check_same_shape(tensor1: torch.Tensor, tensor2: torch.Tensor) -> None:
    if tensor1.shape != tensor2.shape:
        raise ValueError(
            f"tensor1 and tensor2 should have the same shape, but had shapes "
            f"{tuple(tensor1.shape)} and {tuple(tensor2.shape)} respectively."
        )


def are_points_close(tensor1: torch.Tensor, tensor2: torch.Tensor,
                     dist_th: Union[float, int], dim: int = -1) -> torch.Tensor:
    r"""True where the two points are nearer than ``dist_th`` (Euclidean)."""
    _check_same_shape(tensor1, tensor2)
    return torch.linalg.norm(tensor1 - tensor2, dim=dim) < dist_th


def are_normals_similar(tensor1: torch.Tensor, tensor2: torch.Tensor,
                        dot_th: Union[float, int], dim: int = -1) -> torch.Tensor:
    r"""True where the two normals' dot product exceeds ``dot_th``."""
    _check_same_shape(tensor1, tensor2)
    return torch.sum(tensor1 * tensor2, dim=dim) > dot_th


def _gather_pixels(image: torch.Tensor, pix: torch.Tensor) -> torch.Tensor:
    """Rows of ``image (B, H*W, C)`` at each map point's pixel ``pix (B, CAP)``."""
    return gather_rows(image, pix)


def _pixels(active: ActiveMapPoints, W: int) -> torch.Tensor:
    return (active.pix_h * W + active.pix_w).long()


def find_similar_map_points(
    pointclouds: Pointclouds,
    rgbdimages: RGBDImages,
    active: ActiveMapPoints,
    dist_th: Union[float, int],
    dot_th: Union[float, int],
) -> torch.Tensor:
    r"""The active map points that lie within ``dist_th`` of the live
    frame's point at their pixel, with a normal whose dot product with the
    frame's exceeds ``dot_th``: a ``(B, CAP)`` mask."""
    if pointclouds.normals is None:
        raise ValueError(
            "Pointclouds must have normals for finding similar map points, but did not."
        )
    rgbdimages = rgbdimages.to_channels_last()
    B, _, H, W = rgbdimages.shape
    pix = _pixels(active, W)
    frame_points = _gather_pixels(rgbdimages.global_vertex_map.reshape(B, H * W, 3), pix)
    frame_normals = _gather_pixels(rgbdimages.global_normal_map.reshape(B, H * W, 3), pix)
    is_close = are_points_close(frame_points, pointclouds.points, dist_th)
    is_similar = are_normals_similar(frame_normals, pointclouds.normals, dot_th)
    return active.valid & is_close & is_similar


def find_best_unique_correspondences(
    pointclouds: Pointclouds,
    rgbdimages: RGBDImages,
    active: ActiveMapPoints,
    similar_mask: Optional[torch.Tensor] = None,
):
    r"""One winner per pixel among the map points that project to it (the
    ``similar_mask`` rows, else the active ones): the highest confidence
    count, then the smallest squared ray distance to the frame's point,
    then the smallest map row, the reference's lexicographic order. Three
    passes, each a per-pixel ``amax``/``amin`` into a ``(B, H*W)`` table
    (``scatter_reduce_``, order-independent and deterministic) and an exact
    equality test against the copied extreme.

    Returns ``(winner_mask (B, CAP), pixel_corresponded (B, H*W))``.
    """
    if pointclouds.features is None:
        raise ValueError(
            "Pointclouds must have features for finding best unique "
            "correspondences, but did not."
        )
    rgbdimages = rgbdimages.to_channels_last()
    B, _, H, W = rgbdimages.shape
    HW, cap = H * W, pointclouds.capacity
    device = pointclouds.points.device
    mask = active.valid if similar_mask is None else similar_mask
    pix = _pixels(active, W)
    frame_points = _gather_pixels(rgbdimages.global_vertex_map.reshape(B, HW, 3), pix)
    ray_dists = torch.sum((pointclouds.points - frame_points) ** 2, dim=-1)

    def per_pixel(values, fill, reduce):
        table = torch.full((B, HW), fill, dtype=values.dtype, device=device)
        return table.scatter_reduce_(1, pix, values, reduce, include_self=True)

    def at_pixel(table):
        return torch.gather(table, 1, pix)

    # pass 1: the largest confidence count of each pixel
    cc = torch.where(mask, pointclouds.features[..., 0], float("-inf"))
    eligible = mask & (cc == at_pixel(per_pixel(cc, float("-inf"), "amax")))
    # pass 2: the smallest ray distance among those
    rd = torch.where(eligible, ray_dists, float("inf"))
    eligible = eligible & (rd == at_pixel(per_pixel(rd, float("inf"), "amin")))
    # pass 3: the smallest map row, so exactly one winner a pixel
    rows = torch.arange(cap, device=device)[None].expand(B, cap)
    ri = torch.where(eligible, rows, cap)
    min_row = per_pixel(ri, cap, "amin")
    winner = eligible & (rows == at_pixel(min_row))
    return winner, min_row < cap


def find_correspondences(
    pointclouds: Pointclouds,
    rgbdimages: RGBDImages,
    dist_th: Union[float, int],
    dot_th: Union[float, int],
):
    r"""The dense correspondence chain: active, then similar, then the best
    unique winner of each pixel. Returns ``(active, winner_mask (B, CAP),
    pixel_corresponded (B, H*W))``."""
    active = find_active_map_points(pointclouds, rgbdimages)
    similar = find_similar_map_points(pointclouds, rgbdimages, active, dist_th, dot_th)
    winner, pixel_corresponded = find_best_unique_correspondences(
        pointclouds, rgbdimages, active, similar)
    return active, winner, pixel_corresponded


def fuse_with_map(
    pointclouds: Pointclouds,
    rgbdimages: RGBDImages,
    active: ActiveMapPoints,
    winner_mask: torch.Tensor,
    pixel_corresponded: torch.Tensor,
    sigma: Union[float, int, torch.Tensor],
) -> Pointclouds:
    r"""The dense merge: each winning map point takes the confidence-weighted
    average of itself and its pixel's frame point, normal and colour
    (confidences ``get_alpha``); then the valid-depth pixels that no map
    point corresponded to are appended in pixel order through
    :meth:`Pointclouds.append_masked` (on the card, the scatter kernel: one
    call for each of points, normals, colors and features).

    The map must carry normals, float colors and one feature channel (the
    confidence count); a quantized map or one with user feature channels
    goes through :func:`update_map_fusion`.
    """
    if (
        pointclouds.colors is None
        or pointclouds.normals is None
        or pointclouds.features is None
        or pointclouds.features.shape[-1] != 1
    ):
        raise ValueError(
            "fuse_with_map (dense path) requires normals, float colors and a "
            "single ccount feature channel; quantized-layout maps are "
            "supported by update_map_fusion only."
        )
    rgbdimages = rgbdimages.to_channels_last()
    B, _, H, W = rgbdimages.shape
    vertex_flat = rgbdimages.global_vertex_map.reshape(B, H * W, 3)
    normal_flat = rgbdimages.global_normal_map.reshape(B, H * W, 3)
    color_flat = rgbdimages.rgb_image.reshape(B, H * W, 3)
    alpha_flat = get_alpha(rgbdimages.vertex_map, sigma=sigma, dim=4,
                           keepdim=True).reshape(B, H * W, 1)
    pix = _pixels(active, W)

    cc = pointclouds.features
    wm = winner_mask[..., None]
    fa = torch.where(wm, _gather_pixels(alpha_flat, pix), torch.zeros_like(cc))
    updated_cc = cc + fa
    inv_cc = 1.0 / torch.where(updated_cc == 0, torch.ones_like(updated_cc), updated_cc)

    def merged(buf, image):
        new = (cc * buf + fa * _gather_pixels(image, pix)) * inv_cc
        return torch.where(wm, new, buf)

    fused = dataclasses.replace(
        pointclouds,
        points=merged(pointclouds.points, vertex_flat),
        normals=merged(pointclouds.normals, normal_flat),
        colors=merged(pointclouds.colors, color_flat),
        features=torch.where(wm, updated_cc, cc),
    )
    new_mask = rgbdimages.valid_depth_mask.reshape(B, H * W) & ~pixel_corresponded
    return fused.append_masked(vertex_flat, new_mask, normals=normal_flat,
                               colors=color_flat, features=alpha_flat)


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
    ``[ccount, *user]``) or quantized (``colors=None``, features ``[ccount,
    packed_color, *user]``, see :func:`pack_colors`). User feature channels
    are fused like colors, a confidence-weighted running average against
    the frame's ``feature_image``, which must have as many channels.
    """
    rgbdimages = rgbdimages.to_channels_last()
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
    if quantized and pointclouds.features.shape[-1] < 2:
        raise ValueError(
            "update_map_fusion needs either float colors or the quantized layout "
            "(colors=None, features (B, CAP, 2+) = [ccount, packed_color, *user])."
        )
    base = 2 if quantized else 1
    n_user = pointclouds.features.shape[-1] - base
    if n_user > 0:
        if rgbdimages.feature_image is None:
            raise ValueError(
                f"The map carries {n_user} user feature channel(s) but the live frame "
                "has no feature_image: attach RGBDImages.feature_image (B, L, H, W, F) "
                "to fuse features."
            )
        if rgbdimages.feature_image.shape[-1] != n_user:
            raise ValueError(
                f"feature_image has {rgbdimages.feature_image.shape[-1]} channels but "
                f"the map carries {n_user} user feature channel(s): widths must match."
            )
    B, _, H, W = rgbdimages.shape
    cap = pointclouds.capacity
    HW = H * W
    device = pointclouds.points.device
    window = min(active_capacity if active_capacity is not None else 2 * HW, cap)
    association, merge = _resolve_modes(association, merge, cap, HW, window)
    pose = rgbdimages.poses[:, 0]
    K = rgbdimages.intrinsics[:, 0]
    points, normals = pointclouds.points, pointclouds.normals
    feats, user_feats = pointclouds.features[..., :base], pointclouds.features[..., base:]
    # one packed row per map point: points | normals | ccount | packed color
    # (quantized) or float color; user features ride a plane of their own
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
    if n_user > 0:  # fused like colors, from a second gather
        m_uf = gather_rows(user_feats, safe_row)
        ufeat_flat = rgbdimages.feature_image.reshape(B, HW, n_user)
        out_uf = (cc_old * m_uf + alpha_flat * ufeat_flat) * inv_cc

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
    f_end = 6 + base
    if merge == "gather":
        # invert pixel -> row, then every map row gathers its new value
        pix_ids = torch.arange(HW, device=device)[None, :].expand(B, HW)
        row_src = scatter_rows(cap, dest, pix_ids, fill=HW)
        touched = row_src < HW
        src = torch.where(touched, row_src, torch.zeros_like(row_src))
        new_row = torch.where(touched[..., None], gather_rows(out_row, src), map_row)
        features = new_row[..., 6:f_end]
        if n_user > 0:
            new_uf = torch.where(touched[..., None], gather_rows(out_uf, src), user_feats)
            features = torch.cat([features, new_uf], dim=-1)
    else:
        # write the pixel rows over the map rows (rows marked -1 dropped)
        new_row = scatter_rows_into(map_row, dest, out_row)
        features = new_row[..., 6:f_end]
        if n_user > 0:  # the whole features buffer in one more scatter
            features = scatter_rows_into(
                pointclouds.features, dest, torch.cat([out_row[..., 6:f_end], out_uf], dim=-1))
    return dataclasses.replace(
        pointclouds,
        points=new_row[..., :3].contiguous(),
        normals=new_row[..., 3:6].contiguous(),
        features=features.contiguous(),
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
    each point's confidence ``get_alpha`` (``sigma`` 0.6 by default) there,
    followed by the frame's ``feature_image`` channels when the buffer
    carries user channels (``[alpha, *user]``)."""
    if not isinstance(pointclouds, Pointclouds):
        raise TypeError(f"Expected pointclouds to be of type Pointclouds. Got {type(pointclouds)}.")
    if not isinstance(rgbdimages, RGBDImages):
        raise TypeError(f"Expected rgbdimages to be of type RGBDImages. Got {type(rgbdimages)}.")
    rgbdimages = rgbdimages.to_channels_last()
    B, _, H, W = rgbdimages.shape
    features = None
    if pointclouds.features is not None:
        alpha = get_alpha(rgbdimages.vertex_map, sigma=0.6 if sigma is None else sigma,
                          dim=4, keepdim=True)
        features = alpha.reshape(B, H * W, 1)
        n_user = pointclouds.features.shape[-1] - 1
        if n_user > 0:
            plane = rgbdimages.feature_image
            if plane is None or plane.shape[-1] != n_user:
                got = "no feature_image" if plane is None else f"{plane.shape[-1]} channel(s)"
                raise ValueError(
                    f"The map carries {n_user} user feature channel(s) but the live frame "
                    f"has {got}: attach a matching RGBDImages.feature_image (B, L, H, W, F)."
                )
            features = torch.cat([features, plane.reshape(B, H * W, n_user)], dim=-1)
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
    fusionutils.py:827``): every buffer, user feature channels included,
    moves in one compaction of the concatenated rows. ``num_dropped``
    carries over."""
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


_INT_SENTINEL = 2**30  # above every shifted voxel id: invalid rows sort last


def voxel_downsample(
    pointclouds: Pointclouds,
    voxel_size: Union[float, int],
    *,
    reduce: str = "mean",
    quantized_colors: Optional[bool] = None,
) -> Pointclouds:
    r"""One point for each occupied ``voxel_size`` cube (open3d's
    ``voxel_down_sample``; ``gradslam_tpu/slam/fusionutils.py:860``), the
    survivors packed to the front in voxel order and ``num_dropped``
    carried over.

    Integer voxel ids (shifted to be non-negative in each batch row) are
    sorted by ``(vx, vy, vz, row)`` with stable sorts, and the first row of
    each run is its voxel's survivor. ``reduce='mean'`` makes it the
    voxel's mean of every buffer (normals renormalised); ``'first'`` keeps
    the voxel's lowest row unchanged.

    ``quantized_colors``: whether the map has the quantized layout
    (``colors=None``, features ``[ccount, packed_color, *user]``), whose
    packed color is unpacked, averaged and packed again, and whose user
    channels after it average plainly. None detects it as
    :func:`update_map_fusion` does: a colorless cloud with 2 feature
    channels is quantized; one with more is ambiguous (quantized with user
    channels, or a generic descriptor cloud) and raises unless told.

    The voxel sums are ``index_add_`` over the sorted rows: on the card
    their order of additions is not fixed, so a mean may differ in its
    last bits between calls.
    """
    if not voxel_size > 0:
        raise ValueError(f"voxel_size must be > 0. Got {voxel_size}.")
    if reduce not in ("mean", "first"):
        raise ValueError(f"Unknown reduce mode: {reduce!r}.")
    feats = pointclouds.features
    if quantized_colors is None:
        colorless = pointclouds.colors is None and feats is not None
        if colorless and feats.shape[-1] > 2:
            raise ValueError(
                f"voxel_downsample cannot tell whether this colorless {feats.shape[-1]}-"
                "channel feature layout is quantized ([ccount, packed_color, *user]) or "
                "generic: pass quantized_colors=True/False explicitly."
            )
        quantized_colors = colorless and feats.shape[-1] == 2
    elif quantized_colors and (pointclouds.colors is not None or feats is None
                               or feats.shape[-1] < 2):
        raise ValueError(
            "quantized_colors=True expects the quantized map layout (colors=None, "
            "features (B, CAP, 2+) = [ccount, packed_color, *user])."
        )
    pts = pointclouds.points
    B, CAP, _ = pts.shape
    valid = pointclouds.nonpad_mask
    vid = torch.floor(pts / voxel_size).to(torch.int64)
    sentinel = torch.full_like(vid, _INT_SENTINEL)
    vid = vid - torch.where(valid[..., None], vid, sentinel).amin(dim=1, keepdim=True)
    vx, vy, vz = (torch.where(valid, vid[..., k], sentinel[..., k]) for k in range(3))
    order = _lexsort([vz, vy, vx])  # the row is the implicit last key
    s_vx, s_vy, s_vz = (torch.gather(v, 1, order) for v in (vx, vy, vz))
    s_valid = s_vx < _INT_SENTINEL
    first = torch.ones_like(s_valid)
    first[:, 1:] = ((s_vx[:, 1:] != s_vx[:, :-1]) | (s_vy[:, 1:] != s_vy[:, :-1])
                    | (s_vz[:, 1:] != s_vz[:, :-1]))
    first = first & s_valid

    def sorted_rows(buf):
        return gather_rows(buf, order)

    if reduce == "mean":
        seg = torch.cumsum(first.to(torch.int64), dim=1) - 1
        seg = torch.where(s_valid, seg, torch.full_like(seg, CAP - 1))  # park invalid rows
        ones = s_valid.to(pts.dtype)
        cnt = torch.zeros((B, CAP), dtype=pts.dtype, device=pts.device).scatter_add_(1, seg, ones)
        cnt = torch.where(cnt == 0, torch.ones_like(cnt), cnt)

        def reduced(buf):
            if buf is None:
                return None
            v = sorted_rows(buf) * ones[..., None]
            acc = torch.zeros_like(v).scatter_add_(1, seg[..., None].expand_as(v), v)
            return gather_rows(acc / cnt[..., None], seg)

        new_nrm = reduced(pointclouds.normals)
        if new_nrm is not None:
            n2 = torch.sum(new_nrm * new_nrm, dim=-1, keepdim=True)
            pos = n2 > 0
            new_nrm = torch.where(pos, new_nrm / torch.sqrt(torch.where(pos, n2, 1.0)), new_nrm)
        if quantized_colors:
            # the packed integers are not linear in color: unpack, average, pack
            parts = [reduced(feats[..., 0:1]), pack_colors(reduced(unpack_colors(feats[..., 1:2])))]
            if feats.shape[-1] > 2:
                parts.append(reduced(feats[..., 2:]))
            new_feat = torch.cat(parts, dim=-1)
        else:
            new_feat = reduced(feats)
    else:
        def reduced(buf):
            return None if buf is None else sorted_rows(buf)

        new_nrm, new_feat = reduced(pointclouds.normals), reduced(feats)
    bufs = [reduced(pts), new_nrm, reduced(pointclouds.colors), new_feat]
    present = [b for b in bufs if b is not None]
    packed, counts = compact_masked(torch.cat(present, dim=-1), first, CAP)
    parts = iter(torch.split(packed, [b.shape[-1] for b in present], dim=-1))
    points, normals, colors, features = (
        None if b is None else next(parts).contiguous() for b in bufs)
    return Pointclouds(points=points, num_points=counts, normals=normals, colors=colors,
                       features=features, num_dropped=pointclouds.num_dropped)
