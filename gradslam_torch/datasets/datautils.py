r"""Host-side dataset numerics of the PyTorch port (numpy only).

Counterpart of ``gradslam_tpu/datasets/datautils.py`` (``normalize_image``
:26, ``channels_first`` :31, ``scale_intrinsics`` :47,
``pointquaternion_to_homogeneous`` :66, ``poses_to_transforms`` :102,
``labels_to_onehot`` :122, ``create_label_image`` :141), the same code: the
port keeps its own copy because importing ``gradslam_tpu`` imports JAX. The
reference line numbers below are gradslam's ``datasets/datautils.py``.
"""

from __future__ import annotations

import warnings
from typing import List, Sequence, Union

import numpy as np

__all__ = [
    "normalize_image",
    "channels_first",
    "scale_intrinsics",
    "pointquaternion_to_homogeneous",
    "poses_to_transforms",
    "create_label_image",
    "labels_to_onehot",
]


def normalize_image(rgb: np.ndarray) -> np.ndarray:
    r"""Normalize color intensities from ``[0, 255]`` to ``[0, 1]``."""
    return np.asarray(rgb, dtype=np.float32) / 255.0


def channels_first(rgb: np.ndarray) -> np.ndarray:
    r"""Move the channel axis from last to third-from-last:
    ``(*, H, W, C) -> (*, C, H, W)``."""
    rgb = np.asarray(rgb)
    if rgb.ndim < 3:
        raise ValueError(
            f"rgb must have at least 3 dims (H, W, C). Got {rgb.ndim}."
        )
    if rgb.shape[-3] < rgb.shape[-1]:
        warnings.warn(
            "Are you sure the input is in channels-last format? "
            f"Got shape {rgb.shape}."
        )
    return np.moveaxis(rgb, -1, -3)


def scale_intrinsics(
    intrinsics: np.ndarray,
    h_ratio: Union[float, int],
    w_ratio: Union[float, int],
) -> np.ndarray:
    r"""Scale intrinsics for a resized image: fx/cx by ``w_ratio``, fy/cy by
    ``h_ratio`` (reference datautils.py:113-116)."""
    intrinsics = np.array(intrinsics, dtype=np.float32, copy=True)
    if intrinsics.shape[-2:] not in ((3, 3), (4, 4)):
        raise ValueError(
            f"intrinsics must have shape (*, 3, 3) or (*, 4, 4). Got {intrinsics.shape}."
        )
    intrinsics[..., 0, 0] *= w_ratio  # fx
    intrinsics[..., 0, 2] *= w_ratio  # cx
    intrinsics[..., 1, 1] *= h_ratio  # fy
    intrinsics[..., 1, 2] *= h_ratio  # cy
    return intrinsics


def pointquaternion_to_homogeneous(
    pointquaternions: np.ndarray, eps: float = 1e-12
) -> np.ndarray:
    r"""Convert ``(tx, ty, tz, qx, qy, qz, qw)`` rows to ``(*, 4, 4)``
    homogeneous transforms (reference datautils.py:120-216)."""
    pointquaternions = np.asarray(pointquaternions, dtype=np.float32)
    if pointquaternions.shape[-1] != 7:
        raise ValueError(
            f"pointquaternions must have shape (*, 7). Got {pointquaternions.shape}."
        )
    t = pointquaternions[..., :3]
    q = pointquaternions[..., 3:7].astype(np.float64)
    # normalize with eps guard
    norm = np.sqrt((q**2).sum(-1, keepdims=True))
    q = q / np.maximum(norm, eps)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    tx, ty, tz = 2 * x, 2 * y, 2 * z
    twx, twy, twz = tx * w, ty * w, tz * w
    txx, txy, txz = tx * x, ty * x, tz * x
    tyy, tyz, tzz = ty * y, tz * y, tz * z

    out = np.zeros(pointquaternions.shape[:-1] + (4, 4), dtype=np.float32)
    out[..., 0, 0] = 1.0 - (tyy + tzz)
    out[..., 0, 1] = txy - twz
    out[..., 0, 2] = txz + twy
    out[..., 1, 0] = txy + twz
    out[..., 1, 1] = 1.0 - (txx + tzz)
    out[..., 1, 2] = tyz - twx
    out[..., 2, 0] = txz - twy
    out[..., 2, 1] = tyz + twx
    out[..., 2, 2] = 1.0 - (txx + tyy)
    out[..., :3, 3] = t
    out[..., 3, 3] = 1.0
    return out


def poses_to_transforms(
    poses: Union[np.ndarray, Sequence[np.ndarray]]
) -> Union[np.ndarray, List[np.ndarray]]:
    r"""Convert world poses to frame-to-frame transforms: ``T[0] = I``,
    ``T[i] = inv(P[i-1]) @ P[i]`` (reference datautils.py:218-240)."""
    if isinstance(poses, np.ndarray) and poses.ndim == 3:
        seq = [poses[i] for i in range(poses.shape[0])]
        as_array = True
    else:
        seq = list(poses)
        as_array = False
    transforms = []
    for i, pose in enumerate(seq):
        if i == 0:
            transforms.append(np.eye(4, dtype=pose.dtype))
        else:
            transforms.append(np.linalg.inv(seq[i - 1]).astype(pose.dtype) @ pose)
    return np.stack(transforms) if as_array else transforms


def labels_to_onehot(labels: np.ndarray, num_classes: int) -> np.ndarray:
    r"""One-hot encode an integer label image to a float32 feature plane
    ``(*, H, W) -> (*, H, W, num_classes)`` — the input to semantic map
    fusion (attach as ``RGBDImages.feature_image`` and run
    ``PointFusion(feature_channels=num_classes)``). Out-of-range labels
    encode to all-zero rows (fused as "no evidence"). No reference
    equivalent (the reference loads ScanNet labels but never fuses them)."""
    labels = np.asarray(labels)
    if not np.issubdtype(labels.dtype, np.integer):
        raise TypeError(f"labels must be integers. Got dtype {labels.dtype}.")
    if num_classes < 1:
        raise ValueError(f"num_classes must be >= 1. Got {num_classes}.")
    onehot = np.zeros(labels.shape + (num_classes,), dtype=np.float32)
    valid = (labels >= 0) & (labels < num_classes)
    idx = np.nonzero(valid)
    onehot[idx + (labels[valid],)] = 1.0
    return onehot


def create_label_image(prediction: np.ndarray, color_palette: dict) -> np.ndarray:
    r"""Colorize a segmentation-label image with a ``{label: (r, g, b)}``
    palette (reference datautils.py:242-263)."""
    prediction = np.asarray(prediction)
    label_image = np.zeros(prediction.shape + (3,), dtype=np.uint8)
    for label, color in color_palette.items():
        label_image[prediction == label] = color
    return label_image
