"""Odometry of the PyTorch port: GradICP with 1-NN association, and
projective association."""

from .base import OdometryProvider
from .gradicp import GradICPOdometryProvider
from .projective import ProjectiveOdometryProvider

__all__ = ["OdometryProvider", "GradICPOdometryProvider", "ProjectiveOdometryProvider"]
