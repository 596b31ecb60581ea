r"""Projective geometry utilities (PyTorch).

Counterpart of ``gradslam_tpu/geometry/projutils.py``: ``homogenize_points``,
``unhomogenize_points`` (:43), ``project_points`` (:66), ``unproject_points``
and ``inverse_intrinsics`` (:152). All functions broadcast over leading dimensions and keep the device
and dtype of their inputs.
"""

from __future__ import annotations

import torch

__all__ = [
    "homogenize_points",
    "unhomogenize_points",
    "project_points",
    "unproject_points",
    "inverse_intrinsics",
]


def homogenize_points(pts: torch.Tensor) -> torch.Tensor:
    r"""Append a trailing 1: ``(*, K) -> (*, K+1)``."""
    if pts.ndim < 2:
        raise ValueError(
            f"Input tensor must have at least 2 dimensions. Got {pts.ndim} instead."
        )
    return torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)


def unhomogenize_points(pts: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    r"""Drop the trailing homogeneous coordinate: ``(*, K) -> (*, K-1)``,
    divided by it; points at infinity (``|w| <= eps``) are scaled by 1, the
    OpenCV convention the reference follows."""
    if pts.ndim < 2:
        raise ValueError(
            f"Input tensor must have at least 2 dimensions. Got {pts.ndim} instead."
        )
    w = pts[..., -1:]
    one = torch.ones_like(w)
    scale = torch.where(w.abs() > eps, 1.0 / torch.where(w == 0, one, w), one)
    return scale * pts[..., :-1]


def _zdiv(x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Divide by z with the z == 0 -> divide-by-1 guard."""
    return x / torch.where(z == 0, torch.ones_like(z), z)


def project_points(
    cam_coords: torch.Tensor, proj_mat: torch.Tensor, eps: float = 1e-6
) -> torch.Tensor:
    r"""Project camera-frame points ``(*, 3)`` (or homogeneous ``(*, 4)``)
    through ``(4, 4)`` or batched ``(B, 4, 4)`` matrices to pixel
    coordinates ``(*, 2)`` = ``(u, v)``, with the z == 0 divide guard.
    ``eps`` is accepted as in the JAX signature; there too the guard tests
    z == 0 exactly and ``eps`` changes nothing."""
    if cam_coords.ndim < 2:
        raise ValueError(
            f"Input cam_coords must have at least 2 dims. Got {cam_coords.ndim}."
        )
    if cam_coords.shape[-1] not in (3, 4):
        raise ValueError(
            f"Input cam_coords must have shape (*, 3) or (*, 4). Got {tuple(cam_coords.shape)}."
        )
    if proj_mat.ndim < 2 or proj_mat.shape[-2:] != (4, 4):
        raise ValueError(
            f"Input proj_mat must have shape (*, 4, 4). Got {tuple(proj_mat.shape)}."
        )
    if proj_mat.ndim > 2 and proj_mat.ndim != cam_coords.ndim:
        raise ValueError(
            "Batched proj_mat must have ndim equal to cam_coords.ndim. "
            f"Got {proj_mat.ndim} and {cam_coords.ndim}."
        )
    if cam_coords.shape[-1] == 3:
        cam_coords = homogenize_points(cam_coords)
    if proj_mat.ndim == 2:
        pts = torch.einsum("ij,...j->...i", proj_mat, cam_coords)
    else:
        pts = torch.matmul(proj_mat[..., None, :, :], cam_coords[..., None])[..., 0]
    z = pts[..., 2]
    return torch.stack([_zdiv(pts[..., 0], z), _zdiv(pts[..., 1], z)], dim=-1)


def unproject_points(
    pixel_coords: torch.Tensor, intrinsics_inv: torch.Tensor, depths: torch.Tensor
) -> torch.Tensor:
    r"""Unproject pixels ``(*, 2)`` (or homogeneous ``(*, 3)``) with depths
    ``(*,)`` through ``(3, 3)`` or batched ``(B, 3, 3)`` inverse intrinsics
    into camera-frame points ``(*, 3)``."""
    if pixel_coords.ndim < 2:
        raise ValueError(
            f"Input pixel_coords must have at least 2 dims. Got {pixel_coords.ndim}."
        )
    if pixel_coords.shape[-1] not in (2, 3):
        raise ValueError(
            f"Input pixel_coords must have shape (*, 2) or (*, 3). Got {tuple(pixel_coords.shape)}."
        )
    if intrinsics_inv.shape[-2:] != (3, 3):
        raise ValueError(
            f"intrinsics_inv must have shape (*, 3, 3). Got {tuple(intrinsics_inv.shape)}."
        )
    if depths.ndim != pixel_coords.ndim - 1:
        raise ValueError(
            "depths must have one fewer dimension than pixel_coords. "
            f"Got {depths.ndim} and {pixel_coords.ndim}."
        )
    if pixel_coords.shape[-1] == 2:
        pixel_coords = homogenize_points(pixel_coords)
    if intrinsics_inv.ndim == 2:
        pts = torch.einsum("ij,...j->...i", intrinsics_inv, pixel_coords)
    else:
        pts = torch.matmul(intrinsics_inv[..., None, :, :], pixel_coords[..., None])[..., 0]
    return pts * depths[..., None]


def inverse_intrinsics(K: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    r"""Closed-form inverse of zero-skew pinhole intrinsics ``(*, 3, 3)`` or
    ``(*, 4, 4)``, with the reference's ``1 / (f + eps)`` regularisation."""
    if K.ndim < 2 or K.shape[-2:] not in ((3, 3), (4, 4)):
        raise ValueError(
            f"Input K must have shape (*, 3, 3) or (*, 4, 4). Got {tuple(K.shape)}."
        )
    fx, fy = K[..., 0, 0], K[..., 1, 1]
    cx, cy = K[..., 0, 2], K[..., 1, 2]
    Kinv = torch.zeros_like(K)
    Kinv[..., 0, 0] = 1.0 / (fx + eps)
    Kinv[..., 1, 1] = 1.0 / (fy + eps)
    Kinv[..., 0, 2] = -cx / (fx + eps)
    Kinv[..., 1, 2] = -cy / (fy + eps)
    Kinv[..., 2, 2] = 1.0
    Kinv[..., -1, -1] = 1.0
    return Kinv
