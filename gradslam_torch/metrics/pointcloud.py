r"""Pointcloud metrics (PyTorch).

Counterpart of ``gradslam_tpu/metrics/pointcloud.py:18-45``: the chamfer
distance between padded pointclouds. The nearest neighbours come from
:func:`gradslam_torch.ops.nn_points_auto` (the CUDA kernel on the card, the
plain version on the CPU), which returns no gradient; the distance of each
chosen pair is then computed again, differentiably, with the plain
version's formula ``|a|^2 + |b|^2 - 2 a.b`` (FMA-chain norms) and
``torch.maximum`` with 0 (which splits the gradient at a tie, as JAX's
``jnp.maximum``), so the value and its gradient follow the JAX package's
differentiable ``nn_points``.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops import nn_points_auto
from ..ops.knn import _INF, _sq_norm_fma
from ..structures.pointclouds import gather_rows

__all__ = ["chamfer_distance"]


def _zero(x):
    """0 as a 0-d CPU tensor of ``x``'s dtype, which a CUDA op takes as a
    scalar."""
    return torch.zeros((), dtype=x.dtype)


def _nn_sq_dists(src, tgt, tgt_mask):
    """Squared distance ``(B, N)`` from each ``src`` point to its nearest
    valid ``tgt`` point, differentiable in both clouds; 1e30 (constant)
    where no target is valid, as from the search."""
    d_nn, idx = nn_points_auto(src, tgt, tgt_mask)
    t = gather_rows(tgt, idx)
    d2 = _sq_norm_fma(src) + _sq_norm_fma(t) - 2.0 * torch.sum(src * t, dim=-1)
    return torch.where(d_nn >= _INF, d_nn, torch.maximum(d2, _zero(d2)))


def chamfer_distance(
    points_a: torch.Tensor,
    points_b: torch.Tensor,
    mask_a: Optional[torch.Tensor] = None,
    mask_b: Optional[torch.Tensor] = None,
    squared: bool = False,
) -> torch.Tensor:
    r"""Symmetric chamfer distance between two (optionally masked, padded)
    pointclouds ``(N, 3)`` / ``(M, 3)`` or batched ``(B, N, 3)`` /
    ``(B, M, 3)``.

    Returns ``mean_a min_b d(a, b) + mean_b min_a d(a, b)`` (euclidean
    unless ``squared=True``), masked points excluded from both directions:
    a scalar, or ``(B,)`` for batched clouds.
    """
    batched = points_a.ndim == 3
    if not batched:
        points_a, points_b = points_a[None], points_b[None]
        mask_a = None if mask_a is None else mask_a[None]
        mask_b = None if mask_b is None else mask_b[None]
    d_ab = _nn_sq_dists(points_a, points_b, mask_b)
    d_ba = _nn_sq_dists(points_b, points_a, mask_a)
    if not squared:
        d_ab = torch.sqrt(torch.maximum(d_ab, _zero(d_ab)))
        d_ba = torch.sqrt(torch.maximum(d_ba, _zero(d_ba)))

    def masked_mean(d, mask):
        if mask is None:
            return torch.mean(d, dim=-1)
        m = mask.to(d.dtype)
        return torch.sum(d * m, dim=-1) / torch.clamp(torch.sum(m, dim=-1), min=1.0)

    out = masked_mean(d_ab, mask_a) + masked_mean(d_ba, mask_b)
    return out if batched else out[0]
