"""Trajectory and pointcloud metrics of the PyTorch port."""

from .pointcloud import chamfer_distance
from .trajectory import align_trajectories, ate_rmse, rpe

__all__ = ["align_trajectories", "ate_rmse", "chamfer_distance", "rpe"]
