"""Geometry of the PyTorch port."""

from .geometryutils import (
    compose_transformations,
    create_meshgrid,
    inverse_transformation,
    orthonormalize_rotations,
    transform_normals,
    transform_pointcloud,
)
from .projutils import (
    homogenize_points,
    inverse_intrinsics,
    project_points,
    unproject_points,
)
from .se3utils import se3_exp, se3_hat, so3_hat

__all__ = [
    "compose_transformations",
    "create_meshgrid",
    "inverse_transformation",
    "orthonormalize_rotations",
    "transform_normals",
    "transform_pointcloud",
    "homogenize_points",
    "inverse_intrinsics",
    "project_points",
    "unproject_points",
    "se3_exp",
    "se3_hat",
    "so3_hat",
]
