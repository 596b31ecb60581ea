r"""Structure conversions (PyTorch).

Counterpart of ``gradslam_tpu/structures/utils.py``:
``pointclouds_from_rgbdimages`` (:23), frames to a padded point buffer with
the invalid depths compacted away, and ``estimate_normals`` (:98), normals
from local plane fits over the K nearest neighbours.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..ops.knn import knn_points
from .pointclouds import Pointclouds, compact_masked
from .rgbdimages import RGBDImages

__all__ = ["estimate_normals", "pointclouds_from_rgbdimages"]

_EIGH_BATCH = 16_384  # 3x3 matrices a call of torch.linalg.eigh


def pointclouds_from_rgbdimages(
    rgbdimages: RGBDImages,
    global_coordinates: bool = True,
    filter_missing_depths: bool = True,
    capacity: Optional[int] = None,
    sigma: Optional[float] = None,
) -> Pointclouds:
    r"""Sequence-length-1 frames as a :class:`Pointclouds`: the pixels'
    vertices, normals and colors (world frame unless ``global_coordinates``
    is False), the valid depths packed to the front of a ``capacity``-row
    buffer (default ``H * W``) unless ``filter_missing_depths`` is False.
    With ``sigma``, each point's confidence ``exp(-|v|^2 / (2 sigma^2))``
    (camera frame, clamped to ``[1e-7, 1.01]``) is a feature channel, and a
    ``feature_image`` plane follows it; ``num_dropped`` counts the valid
    pixels past the capacity."""
    if not isinstance(rgbdimages, RGBDImages):
        raise TypeError(f"Expected rgbdimages to be of type RGBDImages. Got {type(rgbdimages)}.")
    if rgbdimages.shape[1] != 1:
        raise ValueError(
            f"Expected rgbdimages to have sequence length of 1. Got {rgbdimages.shape[1]}."
        )
    rgbdimages = rgbdimages.to_channels_last()
    B, _, H, W = rgbdimages.shape
    cap = capacity if capacity is not None else H * W
    if global_coordinates:
        vertex, normal = rgbdimages.global_vertex_map, rgbdimages.global_normal_map
    else:
        vertex, normal = rgbdimages.vertex_map, rgbdimages.normal_map
    if filter_missing_depths:
        mask = rgbdimages.valid_depth_mask.reshape(B, H * W)
    else:
        mask = torch.ones((B, H * W), dtype=torch.bool, device=rgbdimages.device)
    bufs = [vertex, normal, rgbdimages.rgb_image]
    if sigma is not None:
        local = rgbdimages.vertex_map
        alpha = torch.exp(-torch.sum(local**2, -1, keepdim=True) / (2.0 * sigma**2))
        bufs.append(torch.clamp(alpha, 1e-7, 1.01))
    if rgbdimages.feature_image is not None:  # after the confidence channel
        bufs.append(rgbdimages.feature_image)
    rows = torch.cat([b.reshape(B, H * W, b.shape[-1]) for b in bufs], dim=-1)
    packed, counts = compact_masked(rows, mask, cap)
    features = packed[..., 9:].contiguous() if rows.shape[-1] > 9 else None
    return Pointclouds(
        points=packed[..., :3].contiguous(), num_points=counts,
        normals=packed[..., 3:6].contiguous(), colors=packed[..., 6:9].contiguous(),
        features=features, num_dropped=mask.sum(dim=-1) - counts,
    )


def estimate_normals(pointclouds: Pointclouds, k: int = 16, viewpoints=None) -> Pointclouds:
    r"""Normals from local plane fits (open3d's ``estimate_normals``): for
    each point, the ``k + 1`` nearest live points (itself included, from
    :func:`~gradslam_torch.ops.knn_points`) give a 3x3 covariance whose
    eigenvector of the smallest eigenvalue (``torch.linalg.eigh``) is the
    normal, turned toward ``viewpoints`` ``(B, 3)`` (default the origin, the
    first camera of the pipelines' maps). Slots past the live count are
    weighted out of the fit, and padded rows get zero normals. Returns the
    cloud with its ``normals`` replaced; differentiable in the points
    through the neighbours. The covariance is full float32 (TF32 off)."""
    if not isinstance(pointclouds, Pointclouds):
        raise TypeError(f"Expected pointclouds to be of type Pointclouds. Got {type(pointclouds)}.")
    if not isinstance(k, int) or k < 2:
        raise ValueError(f"k must be an int >= 2. Got {k}.")
    pts = pointclouds.points
    B, CAP, _ = pts.shape
    if k + 1 > CAP:
        raise ValueError(f"k + 1 ({k + 1}) cannot exceed capacity ({CAP}).")
    mask = pointclouds.nonpad_mask
    nbrs = knn_points(pts, pts, K=k + 1, return_nn=True, tgt_mask=mask).knn  # (B, CAP, K+1, 3)
    live = torch.clamp(pointclouds.num_points, max=k + 1)
    w = (torch.arange(k + 1, device=pts.device)[None, None, :] < live[:, None, None])
    w = w.to(pts.dtype)[..., None]
    wsum = torch.clamp(torch.sum(w, dim=2), min=1.0)
    mean = torch.sum(nbrs * w, dim=2) / wsum
    centered = (nbrs - mean[:, :, None, :]) * w
    cov = torch.einsum("bnki,bnkj->bnij", centered, centered).reshape(-1, 3, 3)
    # eigenvalues ascending; cuSOLVER's batched solver refuses batches of
    # 32,768 and 307,200 matrices (it takes 19,200), so the batch goes in
    # slices
    normals = torch.cat([torch.linalg.eigh(c).eigenvectors[..., 0]
                         for c in cov.split(_EIGH_BATCH)]).reshape(B, CAP, 3)
    if viewpoints is None:
        viewpoints = torch.zeros((B, 3), dtype=pts.dtype, device=pts.device)
    elif tuple(viewpoints.shape) != (B, 3):
        raise ValueError(
            f"viewpoints must have shape (B, 3) = ({B}, 3). Got {tuple(viewpoints.shape)}."
        )
    flip = torch.sum(normals * (viewpoints[:, None, :] - pts), dim=-1, keepdim=True) < 0
    normals = torch.where(flip, -normals, normals)
    normals = torch.where(mask[..., None], normals, torch.zeros_like(normals))
    return dataclasses.replace(pointclouds, normals=normals)
