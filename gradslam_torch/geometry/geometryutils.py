r"""Rigid-body geometry utilities (PyTorch).

Counterpart of ``gradslam_tpu/geometry/geometryutils.py``: ``create_meshgrid``
(:51), ``compose_transformations`` (:75), ``inverse_transformation`` (:90),
``orthonormalize_rotations`` (:110), ``transform_pointcloud`` (:147) and
``transform_normals`` (:167). Transforms broadcast over leading dimensions.
"""

from __future__ import annotations

import torch

__all__ = [
    "create_meshgrid",
    "compose_transformations",
    "inverse_transformation",
    "orthonormalize_rotations",
    "transform_pointcloud",
    "transform_normals",
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
