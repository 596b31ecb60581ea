"""Trajectory metrics of the PyTorch port."""

from .trajectory import align_trajectories, ate_rmse

__all__ = ["align_trajectories", "ate_rmse"]
