"""Odometry of the PyTorch port: ICP (LM) and GradICP (gradLM) with 1-NN
association, projective association, and ground-truth poses, with the
solvers and association functions under them."""

from .base import OdometryProvider
from .gradicp import GradICPOdometryProvider
from .groundtruth import GroundTruthOdometryProvider
from .icp import ICPOdometryProvider
from .icputils import (
    downsample_pointclouds,
    downsample_rgbdimages,
    gauss_newton_solve,
    point_to_plane_gradICP,
    point_to_plane_ICP,
    solve_linear_system,
)
from .projective import (
    ProjectiveOdometryProvider,
    point_to_plane_gradICP_projective,
    point_to_plane_ICP_projective,
    projective_associate,
)

__all__ = [
    "OdometryProvider",
    "GroundTruthOdometryProvider",
    "ICPOdometryProvider",
    "GradICPOdometryProvider",
    "ProjectiveOdometryProvider",
    "solve_linear_system",
    "gauss_newton_solve",
    "point_to_plane_ICP",
    "point_to_plane_gradICP",
    "point_to_plane_ICP_projective",
    "point_to_plane_gradICP_projective",
    "projective_associate",
    "downsample_pointclouds",
    "downsample_rgbdimages",
]
