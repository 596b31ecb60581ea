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
from .structures.structutils import host_tensor

__all__ = ["pointclouds_from_numpy", "rgbdimages_from_numpy", "to_numpy"]


def _float(x, device) -> Optional[torch.Tensor]:
    return host_tensor(x, np.float32, device)


def _count(x, device) -> Optional[torch.Tensor]:
    return host_tensor(x, np.int64, device)


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
    channels_first: bool = False,
    feature_image=None,
    normal_pitch: int = 1,
    device: Union[str, torch.device] = "cuda",
) -> RGBDImages:
    r"""An :class:`RGBDImages` from numpy arrays on ``device`` (the card by
    default), channels-last unless ``channels_first``, with the optional
    ``feature_image`` plane. ``rgbdimages_from_numpy(**to_numpy(f))``
    rebuilds ``f``."""
    return RGBDImages(
        _float(rgb_image, device),
        _float(depth_image, device),
        _float(intrinsics, device),
        _float(poses, device),
        channels_first=channels_first,
        feature_image=_float(feature_image, device),
        normal_pitch=normal_pitch,
    )


def to_numpy(structure: Union[Pointclouds, RGBDImages]) -> Dict[str, object]:
    r"""The fields of a :class:`Pointclouds` or :class:`RGBDImages` as a
    dict: tensors become numpy arrays (None stays None, other fields pass
    through). ``pointclouds_from_numpy(**to_numpy(pc))`` rebuilds ``pc``, and
    ``rgbdimages_from_numpy(**to_numpy(frames))`` rebuilds ``frames``."""
    out = {}
    for field in dataclasses.fields(structure):
        value = getattr(structure, field.name)
        if isinstance(value, torch.Tensor):
            value = value.detach().cpu().numpy()
        out[field.name] = value
    return out
