"""Odometry of the PyTorch port: ICP (LM) and GradICP (gradLM) with 1-NN
association, projective association, and ground-truth poses."""

from .base import OdometryProvider
from .gradicp import GradICPOdometryProvider
from .groundtruth import GroundTruthOdometryProvider
from .icp import ICPOdometryProvider
from .projective import ProjectiveOdometryProvider

__all__ = [
    "OdometryProvider",
    "GradICPOdometryProvider",
    "GroundTruthOdometryProvider",
    "ICPOdometryProvider",
    "ProjectiveOdometryProvider",
]
