"""Odometry of the PyTorch port: ICP (LM) and GradICP (gradLM) with 1-NN
association, and projective association."""

from .base import OdometryProvider
from .gradicp import GradICPOdometryProvider
from .icp import ICPOdometryProvider
from .projective import ProjectiveOdometryProvider

__all__ = [
    "OdometryProvider",
    "GradICPOdometryProvider",
    "ICPOdometryProvider",
    "ProjectiveOdometryProvider",
]
