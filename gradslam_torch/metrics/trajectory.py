r"""Trajectory metrics (PyTorch).

Counterpart of ``gradslam_tpu/metrics/trajectory.py:36-80``: the absolute
trajectory error after Umeyama alignment of the estimated positions to the
ground truth (Sturm et al., IROS 2012). The 3x3 SVD reads nothing back to the
host by itself, but this is an evaluation metric: call it after a run, not
inside one.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["align_trajectories", "ate_rmse"]


def _as_positions(poses: torch.Tensor) -> torch.Tensor:
    if poses.ndim == 3 and poses.shape[-2:] == (4, 4):
        return poses[:, :3, 3]
    if poses.ndim == 2 and poses.shape[-1] == 3:
        return poses
    raise ValueError(f"poses must have shape (L, 4, 4) or (L, 3). Got {tuple(poses.shape)}.")


def align_trajectories(
    est: torch.Tensor, gt: torch.Tensor, with_scale: bool = False
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    r"""Umeyama closed-form alignment: ``(R (3, 3), t (3,), s)`` minimising
    ``||gt - (s R est + t)||`` over positions ``(L, 3)`` or poses
    ``(L, 4, 4)``."""
    est_p = _as_positions(est)
    gt_p = _as_positions(gt)
    n = est_p.shape[0]
    mu_e = est_p.mean(dim=0)
    mu_g = gt_p.mean(dim=0)
    xe = est_p - mu_e
    xg = gt_p - mu_g
    cov = torch.matmul(xg.T, xe) / n
    U, D, Vt = torch.linalg.svd(cov)
    S = torch.eye(3, dtype=est_p.dtype, device=est_p.device)
    det = torch.linalg.det(U) * torch.linalg.det(Vt)
    S[2, 2] = torch.where(det < 0, -1.0, 1.0)
    R = torch.matmul(torch.matmul(U, S), Vt)
    if with_scale:
        var_e = (xe**2).sum() / n
        s = (D * torch.diagonal(S)).sum() / var_e
    else:
        s = torch.ones((), dtype=est_p.dtype, device=est_p.device)
    t = mu_g - s * torch.matmul(R, mu_e)
    return R, t, s


def ate_rmse(est_poses: torch.Tensor, gt_poses: torch.Tensor, align: bool = True) -> torch.Tensor:
    r"""Absolute trajectory error: RMSE of the translational residuals,
    after rigid alignment unless ``align=False``. Shapes ``(L, 4, 4)`` or
    ``(L, 3)``."""
    est_p = _as_positions(est_poses)
    gt_p = _as_positions(gt_poses)
    if est_p.shape != gt_p.shape:
        raise ValueError(
            f"est and gt trajectories must have the same shape. Got "
            f"{tuple(est_p.shape)} and {tuple(gt_p.shape)}."
        )
    if align:
        R, t, s = align_trajectories(est_p, gt_p)
        est_p = s * torch.matmul(est_p, R.T) + t
    err = torch.linalg.norm(est_p - gt_p, dim=-1)
    return torch.sqrt(torch.mean(err**2))
