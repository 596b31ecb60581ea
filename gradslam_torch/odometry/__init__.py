"""Odometry of the PyTorch port (GradICP only so far)."""

from .base import OdometryProvider
from .gradicp import GradICPOdometryProvider

__all__ = ["OdometryProvider", "GradICPOdometryProvider"]
