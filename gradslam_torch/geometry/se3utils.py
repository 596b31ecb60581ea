r"""SO(3)/SE(3) Lie-group operations (PyTorch).

Counterpart of ``gradslam_tpu/geometry/se3utils.py``: ``so3_hat``,
``se3_hat``, ``_rodrigues_coefficients`` (:53), ``so3_exp`` (:69) and
``se3_exp`` (:85). The
reference's first-order small-angle branch (``|w| < 1e-6``) is a
``torch.where`` select with both branches finite, so no NaN from the unused
branch can reach a gradient.
"""

from __future__ import annotations

import torch

from ..utils.precision import fp32_products

_EPS = 1e-6

__all__ = ["so3_hat", "se3_hat", "so3_exp", "se3_exp"]


def so3_hat(omega: torch.Tensor) -> torch.Tensor:
    r"""Skew matrices ``(*, 3, 3)`` of ``(*, 3)`` vectors."""
    if omega.shape[-1] != 3:
        raise ValueError(f"omega must have shape (*, 3). Got {tuple(omega.shape)}.")
    wx, wy, wz = omega.unbind(-1)
    zero = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([zero, -wz, wy], dim=-1),
            torch.stack([wz, zero, -wx], dim=-1),
            torch.stack([-wy, wx, zero], dim=-1),
        ],
        dim=-2,
    )


def se3_hat(xi: torch.Tensor) -> torch.Tensor:
    r"""Twist ``(*, 6)`` laid out ``(v, omega)`` to ``(*, 4, 4)``."""
    if xi.shape[-1] != 6:
        raise ValueError(f"xi must have shape (*, 6). Got {tuple(xi.shape)}.")
    top = torch.cat([so3_hat(xi[..., 3:]), xi[..., :3, None]], dim=-1)
    return torch.cat([top, torch.zeros_like(top[..., :1, :])], dim=-2)


def _rodrigues_coefficients(omega: torch.Tensor):
    """``(A, B, C, small)`` Rodrigues coefficients with the small-angle
    fallback, branch-free. The sqrt never sees 0 (double where)."""
    theta_sq = torch.sum(omega * omega, dim=-1)
    small = theta_sq < _EPS**2
    safe_theta = torch.sqrt(torch.where(small, torch.ones_like(theta_sq), theta_sq))
    s, c = torch.sin(safe_theta), torch.cos(safe_theta)
    zero, one = torch.zeros_like(safe_theta), torch.ones_like(safe_theta)
    A = torch.where(small, one, s / safe_theta)
    B = torch.where(small, zero, (1.0 - c) / safe_theta**2)
    C = torch.where(small, zero, (safe_theta - s) / safe_theta**3)
    return A, B, C, small


@fp32_products()
def so3_exp(omega: torch.Tensor) -> torch.Tensor:
    r"""Exponential map so(3) -> SO(3): ``(*, 3)`` to ``(*, 3, 3)``, with
    the first-order ``I + w^`` branch below ``|w| = 1e-6``."""
    omega_hat = so3_hat(omega)
    omega_hat_sq = torch.matmul(omega_hat, omega_hat)
    A, B, _, small = _rodrigues_coefficients(omega)
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device).expand(omega_hat.shape)
    R_full = eye + A[..., None, None] * omega_hat + B[..., None, None] * omega_hat_sq
    return torch.where(small[..., None, None], eye + omega_hat, R_full)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    r"""Exponential map se(3) -> SE(3): ``(*, 6)`` (or ``(*, 6, 1)``) twists
    ``(v, omega)`` to ``(*, 4, 4)`` transforms."""
    if xi.ndim >= 2 and xi.shape[-1] == 1 and xi.shape[-2] == 6:
        xi = xi[..., 0]
    if xi.shape[-1] != 6:
        raise ValueError(f"xi must have shape (*, 6). Got {tuple(xi.shape)}.")
    v, omega = xi[..., :3], xi[..., 3:]
    omega_hat = so3_hat(omega)
    omega_hat_sq = torch.matmul(omega_hat, omega_hat)
    A, B, C, small = _rodrigues_coefficients(omega)
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device).expand(omega_hat.shape)
    A, B, C = A[..., None, None], B[..., None, None], C[..., None, None]
    small = small[..., None, None]
    R_full = eye + A * omega_hat + B * omega_hat_sq
    V_full = eye + B * omega_hat + C * omega_hat_sq
    first_order = eye + omega_hat
    R = torch.where(small, first_order, R_full)
    V = torch.where(small, first_order, V_full)
    t = torch.matmul(V, v[..., None])
    top = torch.cat([R, t], dim=-1)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)
