"""Geometry of the PyTorch port."""

from .geometryutils import (
    cam2pixel,
    compose_transformations,
    create_meshgrid,
    inverse_transformation,
    normalize_pixel_coords,
    normalize_quaternion,
    orthonormalize_rotations,
    pixel2cam,
    quaternion_to_axisangle,
    quaternion_to_rotation_matrix,
    relative_transformation,
    transform_normals,
    transform_pointcloud,
    transform_pts_3d,
    transform_pts_nd,
    unnormalize_pixel_coords,
)
from .projutils import (
    homogenize_points,
    inverse_intrinsics,
    project_points,
    unhomogenize_points,
    unproject_points,
)
from .se3utils import se3_exp, se3_hat, so3_exp, so3_hat

# The JAX package's list, in its order.
__all__ = [
    "homogenize_points",
    "unhomogenize_points",
    "project_points",
    "unproject_points",
    "inverse_intrinsics",
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
    "pixel2cam",
    "so3_hat",
    "se3_hat",
    "so3_exp",
    "se3_exp",
]
