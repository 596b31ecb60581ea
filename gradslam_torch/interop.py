r"""State carried across between numpy and the port's structures.

SLAM has no weights: its state is the map and the frames. These functions
build port structures from numpy arrays and turn them back, so that one
state (for example a map that the JAX package built half-way through a
sequence, read out with ``np.asarray``) can start both pipelines.

The structures land on the card (``device="cuda"``) unless the caller asks
for another device: a run on the CPU is asked for, never fallen into.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Union

import numpy as np
import torch

from .structures.pointclouds import Pointclouds
from .structures.rgbdimages import RGBDImages

__all__ = ["pointclouds_from_numpy", "rgbdimages_from_numpy", "to_numpy"]


def _float(x, device) -> Optional[torch.Tensor]:
    if x is None:
        return None
    return torch.tensor(np.asarray(x, dtype=np.float32), device=device)


def _count(x, device) -> Optional[torch.Tensor]:
    if x is None:
        return None
    return torch.tensor(np.asarray(x, dtype=np.int64), device=device)


def pointclouds_from_numpy(
    points,
    num_points,
    normals=None,
    colors=None,
    features=None,
    num_dropped=None,
    device: Union[str, torch.device] = "cuda",
) -> Pointclouds:
    r"""A :class:`Pointclouds` from padded numpy buffers ``(B, CAP, *)`` and
    counters ``(B,)`` (float32 buffers, int64 counters) on ``device`` (the
    card by default). The arrays are copied, never aliased."""
    return Pointclouds(
        points=_float(points, device),
        num_points=_count(num_points, device),
        normals=_float(normals, device),
        colors=_float(colors, device),
        features=_float(features, device),
        num_dropped=_count(num_dropped, device),
    )


def rgbdimages_from_numpy(
    rgb_image,
    depth_image,
    intrinsics,
    poses=None,
    *,
    normal_pitch: int = 1,
    device: Union[str, torch.device] = "cuda",
) -> RGBDImages:
    r"""A channels-last :class:`RGBDImages` from numpy arrays on ``device``
    (the card by default)."""
    return RGBDImages(
        _float(rgb_image, device),
        _float(depth_image, device),
        _float(intrinsics, device),
        _float(poses, device),
        normal_pitch=normal_pitch,
    )


def to_numpy(structure: Union[Pointclouds, RGBDImages]) -> Dict[str, object]:
    r"""The fields of a :class:`Pointclouds` or :class:`RGBDImages` as a
    dict: tensors become numpy arrays (None stays None, other fields pass
    through). ``pointclouds_from_numpy(**to_numpy(pc))`` rebuilds ``pc``."""
    out = {}
    for field in dataclasses.fields(structure):
        value = getattr(structure, field.name)
        if isinstance(value, torch.Tensor):
            value = value.detach().cpu().numpy()
        out[field.name] = value
    return out
