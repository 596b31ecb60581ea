r"""Rigid-body geometry utilities (PyTorch).

Counterpart of ``gradslam_tpu/geometry/geometryutils.py``: ``create_meshgrid``
(:51), ``compose_transformations`` (:75), ``inverse_transformation`` (:90),
``orthonormalize_rotations`` (:110), ``relative_transformation`` (:138),
``transform_pointcloud`` (:147), ``transform_normals`` (:167), the grid
transforms ``transform_pts_3d``/``transform_pts_nd`` (:184-221), the pixel
normalisation and camera/pixel helpers (:224-268, :338), the quaternion
helpers (:271-310) and the reference's ``*_3d`` transform names (:312-336).
Transforms broadcast over leading dimensions. The helpers that a user calls
outside a pipeline contract in full float32 (``fp32_products``).
"""

from __future__ import annotations

import torch

from ..utils.precision import fp32_products

# The reference also defines homogenize/unhomogenize here; they live in
# projutils and are importable from both modules, as in the JAX package.
from .projutils import homogenize_points, unhomogenize_points

__all__ = [
    "homogenize_points",
    "unhomogenize_points",
    "create_meshgrid",
    "compose_transformations",
    "inverse_transformation",
    "orthonormalize_rotations",
    "relative_transformation",
    "transform_pointcloud",
    "transform_normals",
    "normalize_quaternion",
    "quaternion_to_rotation_matrix",
    "quaternion_to_axisangle",
    "transform_pts_3d",
    "transform_pts_nd",
    "normalize_pixel_coords",
    "unnormalize_pixel_coords",
    "cam2pixel",
    "cam2pixel_KF",
    "pixel2cam",
    "inverse_transfom_3d",
    "compose_transforms_3d",
    "relative_transform_3d",
]


def _check_transform(transform: torch.Tensor, name: str = "transform") -> None:
    if transform.shape[-2:] != (4, 4):
        raise ValueError(
            f"{name} must have shape (*, 4, 4). Got {tuple(transform.shape)}."
        )


def create_meshgrid(
    height: int,
    width: int,
    normalized_coords: bool = True,
    *,
    device=None,
    dtype=torch.float32,
) -> torch.Tensor:
    r"""Pixel grid ``(1, H, W, 2)``: ``[..., 0]`` is the row, ``[..., 1]``
    the column; ``[-1, 1]`` ranges when ``normalized_coords``, else
    ``[0, H-1] x [0, W-1]``."""
    if not isinstance(height, int) or not isinstance(width, int):
        raise TypeError(
            f"height and width must be integers. Got {type(height)}, {type(width)}."
        )
    if normalized_coords:
        xs = torch.linspace(-1.0, 1.0, height, device=device, dtype=dtype)
        ys = torch.linspace(-1.0, 1.0, width, device=device, dtype=dtype)
    else:
        xs = torch.arange(height, device=device, dtype=dtype)
        ys = torch.arange(width, device=device, dtype=dtype)
    rows, cols = torch.meshgrid(xs, ys, indexing="ij")
    return torch.stack([rows, cols], dim=-1)[None]


def compose_transformations(trans_01: torch.Tensor, trans_12: torch.Tensor) -> torch.Tensor:
    r"""``T_02 = T_01 @ T_12`` for ``(*, 4, 4)`` transforms."""
    _check_transform(trans_01, "trans_01")
    _check_transform(trans_12, "trans_12")
    return torch.matmul(trans_01, trans_12)


def inverse_transformation(trans: torch.Tensor) -> torch.Tensor:
    r"""Rigid inverse ``[R^T | -R^T t]`` of ``(*, 4, 4)`` transforms."""
    _check_transform(trans)
    rmat_t = trans[..., :3, :3].transpose(-1, -2)
    tvec_inv = -torch.matmul(rmat_t, trans[..., :3, 3:4])[..., 0]
    out = torch.zeros_like(trans)
    out[..., :3, :3] = rmat_t
    out[..., :3, 3] = tvec_inv
    out[..., 3, 3] = 1.0
    return out


def orthonormalize_rotations(trans: torch.Tensor) -> torch.Tensor:
    r"""Project the rotation blocks of ``(*, 4, 4)`` transforms onto SO(3)
    with one Newton step of the polar decomposition,
    ``R <- R (3I - R^T R) / 2`` (an orthonormality error ``eps`` becomes
    ``O(eps^2)``; three 3x3 matmuls, no SVD, so no host sync on the card).

    The constant-velocity prediction ``pose_k @ pose_{k-1}^-1 @ pose_k``
    otherwise doubles the float32 orthonormality error every frame, and
    ``det(R)`` overflows within about 20 frames."""
    _check_transform(trans)
    R = trans[..., :3, :3]
    RtR = torch.matmul(R.transpose(-1, -2), R)
    eye = torch.eye(3, dtype=trans.dtype, device=trans.device)
    out = trans.clone()
    out[..., :3, :3] = torch.matmul(R, 1.5 * eye - 0.5 * RtR)
    return out


def relative_transformation(trans_01: torch.Tensor, trans_02: torch.Tensor) -> torch.Tensor:
    r"""``T_12 = T_01^-1 @ T_02`` for ``(*, 4, 4)`` transforms."""
    _check_transform(trans_02, "trans_02")
    return torch.matmul(inverse_transformation(trans_01), trans_02)


def transform_pointcloud(pointcloud: torch.Tensor, transform: torch.Tensor) -> torch.Tensor:
    r"""``p' = R p + t`` for points ``(*, N, 3)`` and transforms ``(4, 4)``
    or ``(*, 4, 4)``."""
    if pointcloud.shape[-1] != 3:
        raise ValueError(
            f"pointcloud must have shape (*, 3). Got {tuple(pointcloud.shape)}."
        )
    _check_transform(transform)
    rmat = transform[..., :3, :3]
    tvec = transform[..., :3, 3]
    if transform.ndim == 2:
        return torch.einsum("ij,...j->...i", rmat, pointcloud) + tvec
    return torch.einsum("...ij,...nj->...ni", rmat, pointcloud) + tvec[..., None, :]


def transform_normals(normals: torch.Tensor, transform: torch.Tensor) -> torch.Tensor:
    r"""Rotate normals ``(*, N, 3)`` by the rotation part of ``(4, 4)`` or
    ``(*, 4, 4)`` transforms (no translation)."""
    if normals.shape[-1] != 3:
        raise ValueError(f"normals must have shape (*, 3). Got {tuple(normals.shape)}.")
    _check_transform(transform)
    rmat = transform[..., :3, :3]
    if transform.ndim == 2:
        return torch.einsum("ij,...j->...i", rmat, normals)
    return torch.einsum("...ij,...nj->...ni", rmat, normals)


@fp32_products()
def transform_pts_3d(pts: torch.Tensor, transform: torch.Tensor) -> torch.Tensor:
    r"""Apply ``(4, 4)`` transforms to points ``(*, 3)``, grids such as
    ``(H, W, 3)`` included. A batched ``(B, ..., 4, 4)`` transform lines up
    with the leading point dims and broadcasts over the rest: ``(B, 4, 4)``
    over ``(B, H, W, 3)`` gets one broadcast axis per trailing point dim."""
    _check_transform(transform)
    rmat = transform[..., :3, :3]
    tvec = transform[..., :3, 3]
    if transform.ndim == 2:
        return torch.einsum("ij,...j->...i", rmat, pts) + tvec
    nb = transform.ndim - 2
    extra = pts.ndim - 1 - nb
    if extra < 0:
        raise ValueError(
            f"transform batch dims ({tuple(transform.shape[:-2])}) exceed point "
            f"dims ({tuple(pts.shape[:-1])})."
        )
    batch = tuple(transform.shape[:nb]) + (1,) * extra
    rmat = rmat.reshape(batch + (3, 3))
    tvec = tvec.reshape(batch + (3,))
    return torch.matmul(rmat, pts[..., None])[..., 0] + tvec


def transform_pts_nd(pts: torch.Tensor, transform: torch.Tensor) -> torch.Tensor:
    r"""Batched transform of points ``(*, 3)`` by ``(*, 4, 4)`` matrices
    broadcast over the point dims (the reference's ``transform_pts_nd_KF``);
    broadcasting as :func:`transform_pts_3d`."""
    return transform_pts_3d(pts, transform)


# The reference's name ("KF" for KinectFusion-style use).
transform_pts_nd_KF = transform_pts_nd


def _check_pixels(coords: torch.Tensor, name: str) -> None:
    if coords.shape[-1] != 2:
        raise ValueError(f"{name} must have shape (*, 2). Got {tuple(coords.shape)}.")


def normalize_pixel_coords(pixel_coords: torch.Tensor, height: int, width: int) -> torch.Tensor:
    r"""Pixel coordinates ``(*, 2)`` in (x = column, y = row) order from
    ``[0, W-1] x [0, H-1]`` to ``[-1, 1]``."""
    _check_pixels(pixel_coords, "pixel_coords")
    wh = torch.tensor([width - 1, height - 1], dtype=pixel_coords.dtype,
                      device=pixel_coords.device)
    return 2.0 * pixel_coords / wh - 1.0


def unnormalize_pixel_coords(pixel_coords_norm: torch.Tensor, height: int,
                             width: int) -> torch.Tensor:
    r"""Inverse of :func:`normalize_pixel_coords`."""
    _check_pixels(pixel_coords_norm, "pixel_coords_norm")
    wh = torch.tensor([width - 1, height - 1], dtype=pixel_coords_norm.dtype,
                      device=pixel_coords_norm.device)
    return (pixel_coords_norm + 1.0) * wh / 2.0


def _divide_by_z(pts: torch.Tensor) -> torch.Tensor:
    z = pts[..., 2]
    zg = torch.where(z == 0, torch.ones_like(z), z)
    return torch.stack([pts[..., 0] / zg, pts[..., 1] / zg], dim=-1)


def _check_cam_coords(cam_coords_src: torch.Tensor) -> None:
    if cam_coords_src.shape[-1] != 3:
        raise ValueError(
            f"cam_coords_src must have shape (*, 3). Got {tuple(cam_coords_src.shape)}."
        )


def cam2pixel(cam_coords_src: torch.Tensor, dst_proj_src: torch.Tensor,
              eps: float = 1e-6) -> torch.Tensor:
    r"""Camera-frame points ``(*, 3)`` through ``(*, 4, 4)`` projections to
    pixel coordinates ``(u, v)``, dividing by ``z`` with the ``z == 0``
    guard. ``eps`` is accepted for the reference's signature and unused, as
    in the JAX package."""
    _check_cam_coords(cam_coords_src)
    return _divide_by_z(transform_pts_3d(cam_coords_src, dst_proj_src))


def cam2pixel_KF(cam_coords_src: torch.Tensor, P: torch.Tensor,
                 eps: float = 1e-6) -> torch.Tensor:
    r"""The KinectFusion-style :func:`cam2pixel`: camera coordinates
    ``(*, 3)`` through a ``(4, 4)`` or batched ``(*, 4, 4)`` projection ``P``
    (:func:`transform_pts_nd`), with the ``z == 0`` guard."""
    _check_cam_coords(cam_coords_src)
    if P.ndim < 2 or P.shape[-2:] != (4, 4):
        raise ValueError(f"P must have shape (*, 4, 4). Got {tuple(P.shape)}.")
    return _divide_by_z(transform_pts_nd(cam_coords_src, P))


def pixel2cam(depth: torch.Tensor, intrinsics_inv: torch.Tensor,
              pixel_coords: torch.Tensor) -> torch.Tensor:
    r"""Unproject homogeneous pixel coordinates ``(*, 3)`` through
    ``(*, 4, 4)`` inverse intrinsics, scaled by the per-pixel ``depth``
    ``(*)``, into the camera frame."""
    return transform_pts_3d(pixel_coords, intrinsics_inv) * depth[..., None]


def normalize_quaternion(quaternion: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    r"""Quaternions ``(*, 4)`` scaled to unit norm (the norm floored at
    ``eps``)."""
    if quaternion.shape[-1] != 4:
        raise ValueError(f"quaternion must have shape (*, 4). Got {tuple(quaternion.shape)}.")
    norm = torch.linalg.norm(quaternion, dim=-1, keepdim=True)
    return quaternion / torch.clamp(norm, min=eps)


def quaternion_to_rotation_matrix(quaternion: torch.Tensor) -> torch.Tensor:
    r"""Rotation matrices ``(*, 3, 3)`` of quaternions ``(*, 4)`` in
    ``(x, y, z, w)`` order (the reference's), normalised first."""
    x, y, z, w = normalize_quaternion(quaternion).unbind(-1)
    tx, ty, tz = 2.0 * x, 2.0 * y, 2.0 * z
    twx, twy, twz = tx * w, ty * w, tz * w
    txx, txy, txz = tx * x, ty * x, tz * x
    tyy, tyz, tzz = ty * y, tz * y, tz * z
    return torch.stack(
        [
            torch.stack([1.0 - (tyy + tzz), txy - twz, txz + twy], dim=-1),
            torch.stack([txy + twz, 1.0 - (txx + tzz), tyz - twx], dim=-1),
            torch.stack([txz - twy, tyz + twx, 1.0 - (txx + tyy)], dim=-1),
        ],
        dim=-2,
    )


def quaternion_to_axisangle(quaternion: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    r"""Axis-angle vectors ``(*, 3)`` of quaternions ``(*, 4)`` in
    ``(x, y, z, w)`` order: the angle from ``atan2``, and twice the vector
    part where its norm is below ``eps``."""
    q = normalize_quaternion(quaternion, eps)
    xyz, w = q[..., :3], q[..., 3]
    sin_half = torch.linalg.norm(xyz, dim=-1)
    small = sin_half < eps
    safe_sin = torch.where(small, torch.ones_like(sin_half), sin_half)
    scale = torch.where(small, torch.full_like(sin_half, 2.0),
                        2.0 * torch.atan2(sin_half, w) / safe_sin)
    return xyz * scale[..., None]


@fp32_products()
def inverse_transfom_3d(trans: torch.Tensor) -> torch.Tensor:
    r"""Invert ``(*, 4, 4)`` rigid transforms. The reference's misspelt
    name, kept because users call it; :func:`inverse_transformation` is the
    same function."""
    return inverse_transformation(trans)


@fp32_products()
def compose_transforms_3d(trans1: torch.Tensor, trans2: torch.Tensor) -> torch.Tensor:
    r"""``trans1 @ trans2`` for two ``(*, 4, 4)`` transforms of one shape."""
    if trans1.shape != trans2.shape:
        raise ValueError(
            "Both input transformations must have the same shape. "
            f"Got {tuple(trans1.shape)} and {tuple(trans2.shape)}."
        )
    return compose_transformations(trans1, trans2)


def relative_transform_3d(trans_01: torch.Tensor, trans_02: torch.Tensor) -> torch.Tensor:
    r"""``trans_12 = trans_01^-1 @ trans_02`` for ``(*, 4, 4)`` transforms
    of one shape."""
    return compose_transforms_3d(inverse_transfom_3d(trans_01), trans_02)
