r"""Point-to-plane GradICP solver toolbox (PyTorch).

Counterpart of ``gradslam_tpu/odometry/icputils.py``: ``solve_linear_system``
(:53), ``gauss_newton_solve`` (:170), ``_ptp_system`` (:212),
``point_to_plane_gradICP`` (:460, fresh lookahead, no robust kernel and no
normal gate), ``downsample_pointclouds`` (:556) and ``downsample_rgbdimages``
(:590).

The JAX solvers work on one cloud pair and are ``vmap``-ed; here every
function takes an explicit leading batch dimension, and the ``lax.scan``
over solver iterations is a Python loop. Invalid rows of the linear system
are zeroed, so they add nothing to the normal equations, and the damped 6x6
systems are solved with ``torch.linalg.solve_ex(check_errors=False)``, which
does not read an error flag back to the host.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..geometry.geometryutils import transform_pointcloud
from ..geometry.se3utils import se3_exp
from ..ops import nn_points_auto
from ..structures.pointclouds import Pointclouds, compact_masked, gather_rows
from ..structures.rgbdimages import RGBDImages

__all__ = [
    "solve_linear_system",
    "gauss_newton_solve",
    "point_to_plane_gradICP",
    "downsample_pointclouds",
    "downsample_rgbdimages",
]


def solve_linear_system(A: torch.Tensor, b: torch.Tensor, damp=1e-8) -> torch.Tensor:
    r"""Solve ``(A^T A + damp I) x = A^T b`` for ``A (B, N, 6)``,
    ``b (B, N, 1)`` and ``damp`` a float or ``(B,)`` tensor. Returns
    ``(B, 6, 1)``. Invalid rows must be zeroed by the caller."""
    if A.ndim != 3 or b.ndim != 3 or b.shape[-1] != 1 or A.shape[:2] != b.shape[:2]:
        raise ValueError(
            f"A and b must be (B, N, K) and (B, N, 1). Got {tuple(A.shape)} and {tuple(b.shape)}."
        )
    damp = torch.as_tensor(damp, dtype=A.dtype, device=A.device).reshape(-1, 1, 1)
    At = A.transpose(1, 2)
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    AtA = torch.matmul(At, A) + damp * eye
    x, _info = torch.linalg.solve_ex(AtA, torch.matmul(At, b), check_errors=False)
    return x


def _ptp_system(s, assoc_pts, assoc_normals, valid):
    """Masked point-to-plane rows ``A = [n | s x n]``, ``b = n . (d - s)``."""
    n = assoc_normals
    A = torch.cat([n, torch.linalg.cross(s, n, dim=-1)], dim=-1)
    b = torch.sum(n * (assoc_pts - s), dim=-1, keepdim=True)
    validf = valid[..., None].to(A.dtype)
    return A * validf, b * validf


def gauss_newton_solve(
    src_pc: torch.Tensor,  # (B, N, 3)
    tgt_pc: torch.Tensor,  # (B, M, 3)
    tgt_normals: torch.Tensor,  # (B, M, 3)
    src_mask: Optional[torch.Tensor] = None,  # (B, N) bool
    tgt_mask: Optional[torch.Tensor] = None,  # (B, M) bool
    dist_thresh: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    r"""Linearise the point-to-plane error around the current source cloud.
    Returns ``(A (B, N, 6), b (B, N, 1), chamfer_idx (B, N))``; rows of
    masked-out or distance-filtered source points are zero."""
    dists, idx = nn_points_auto(src_pc, tgt_pc, tgt_mask)
    valid = (
        torch.ones(src_pc.shape[:2], dtype=torch.bool, device=src_pc.device)
        if src_mask is None else src_mask
    )
    if dist_thresh is not None:
        valid = valid & (dists < dist_thresh)
    A, b = _ptp_system(
        src_pc, gather_rows(tgt_pc, idx), gather_rows(tgt_normals, idx), valid
    )
    return A, b, idx


def point_to_plane_gradICP(
    src_pc: torch.Tensor,
    tgt_pc: torch.Tensor,
    tgt_normals: torch.Tensor,
    initial_transform: Optional[torch.Tensor] = None,
    numiters: int = 20,
    damp: float = 1e-8,
    dist_thresh: Optional[float] = None,
    lambda_max: float = 2.0,
    B: float = 1.0,
    B2: float = 1.0,
    nu: float = 200.0,
    src_mask: Optional[torch.Tensor] = None,
    tgt_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    r"""Differentiable gradLM ICP (reference icputils.py:370-545): smooth
    sigmoid-blended damping and step scaling, the step always applied, the
    error difference clamped to +-70. The lookahead error re-associates
    (a second nearest-neighbour search per iteration).

    Clouds are ``(N, 3)`` or batched ``(B, N, 3)``; masks ``(N,)``/``(B, N)``.
    Returns ``(transform, chamfer_idx)``: ``(4, 4)`` and ``(N,)`` for
    unbatched input, ``(B, 4, 4)`` and ``(B, N)`` for batched input.
    """
    if numiters < 1:
        raise ValueError(f"numiters must be >= 1. Got {numiters}.")
    batched = src_pc.ndim == 3
    if not batched:
        src_pc, tgt_pc, tgt_normals = src_pc[None], tgt_pc[None], tgt_normals[None]
        src_mask = None if src_mask is None else src_mask[None]
        tgt_mask = None if tgt_mask is None else tgt_mask[None]
        if initial_transform is not None:
            initial_transform = initial_transform[None]
    nb = src_pc.shape[0]
    if initial_transform is None:
        initial_transform = torch.eye(
            4, dtype=src_pc.dtype, device=src_pc.device
        ).expand(nb, 4, 4)
    transform = initial_transform
    pc = transform_pointcloud(src_pc, transform)
    damp_t = torch.full((nb,), damp, dtype=src_pc.dtype, device=src_pc.device)
    lambda_min = 1.0 / lambda_max

    def gn(p):
        return gauss_newton_solve(p, tgt_pc, tgt_normals, src_mask, tgt_mask, dist_thresh)

    idx = None
    for _ in range(numiters):
        A, b, idx = gn(pc)
        xi = solve_linear_system(A, b, damp_t)[..., 0]  # (B, 6)
        residual_transform = se3_exp(xi)
        err = torch.sum(b * b, dim=(1, 2))
        one_step_pc = transform_pointcloud(pc, residual_transform)
        _, b1, _ = gn(one_step_pc)
        new_err = torch.sum(b1 * b1, dim=(1, 2))

        errdiff = torch.clamp(new_err - err, -70.0, 70.0)
        damp_new = lambda_min + (lambda_max - lambda_min) / (1.0 + torch.exp(-B * errdiff))
        damp_t = damp_t * damp_new
        sigmoid = 1.0 / (1.0 + torch.exp(-B2 * errdiff)) ** (1.0 / nu)
        scaled_transform = se3_exp(sigmoid[:, None] * xi)
        pc = transform_pointcloud(pc, scaled_transform)
        transform = torch.matmul(scaled_transform, transform)
    if not batched:
        return transform[0], idx[0]
    return transform, idx


def downsample_pointclouds(
    pointclouds: Pointclouds,
    active_mask: torch.Tensor,  # (B, CAP) bool
    pix_h: torch.Tensor,  # (B, CAP) int
    pix_w: torch.Tensor,  # (B, CAP) int
    ds_ratio: int,
    capacity: int,
) -> Pointclouds:
    r"""Active map points whose projected pixel is ``0 mod ds`` in both axes,
    compacted into a fixed ``capacity`` buffer. Overflow past ``capacity`` is
    recorded in the returned cloud's ``num_dropped``."""
    if not isinstance(ds_ratio, int):
        raise TypeError(f"Expected ds_ratio to be of type int. Got {type(ds_ratio)}.")
    keep = active_mask & (pix_h % ds_ratio == 0) & (pix_w % ds_ratio == 0)
    points, counts = compact_masked(pointclouds.points, keep, capacity)

    def compact(buf):
        return None if buf is None else compact_masked(buf, keep, capacity)[0]

    return Pointclouds(
        points=points,
        num_points=counts,
        normals=compact(pointclouds.normals),
        colors=compact(pointclouds.colors),
        num_dropped=keep.sum(dim=-1) - counts,
    )


def downsample_rgbdimages(rgbdimages: RGBDImages, ds_ratio: int) -> Pointclouds:
    r"""Strided subsample of a sequence-length-1 frame into a
    :class:`Pointclouds`, invalid-depth points compacted out."""
    if not isinstance(rgbdimages, RGBDImages):
        raise TypeError(
            f"Expected rgbdimages to be of type RGBDImages. Got {type(rgbdimages)}."
        )
    if not isinstance(ds_ratio, int):
        raise TypeError(f"Expected ds_ratio to be of type int. Got {type(ds_ratio)}.")
    if rgbdimages.shape[1] != 1:
        raise ValueError(
            f"Sequence length of rgbdimages must be 1, but was {rgbdimages.shape[1]}."
        )
    B = len(rgbdimages)
    mask = rgbdimages.valid_depth_mask[:, 0, ::ds_ratio, ::ds_ratio, 0].reshape(B, -1)
    N = mask.shape[1]

    def flat(x):
        return x[:, 0, ::ds_ratio, ::ds_ratio].reshape(B, N, 3)

    points, counts = compact_masked(flat(rgbdimages.global_vertex_map), mask, N)
    normals, _ = compact_masked(flat(rgbdimages.global_normal_map), mask, N)
    colors, _ = compact_masked(flat(rgbdimages.rgb_image), mask, N)
    return Pointclouds(points=points, num_points=counts, normals=normals, colors=colors)
