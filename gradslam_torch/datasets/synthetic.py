r"""Synthetic RGB-D sequences (numpy only).

Counterpart of ``gradslam_tpu/datasets/synthetic.py:22-89``: a procedurally
rendered static scene — a gently wavy wall observed by a slowly translating
camera with mm-scale sensor noise. The same seed gives the same arrays as the
JAX package's ``synthetic_sequence``, so both packages can be driven with one
clip. The port cannot import the original: importing ``gradslam_tpu`` imports
JAX.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

__all__ = ["synthetic_sequence"]


@lru_cache(maxsize=8)
def _pixel_grids(H, W):
    return np.meshgrid(np.arange(H), np.arange(W), indexing="ij")


def _render_depth(H, W, fx, cx, cy, tx, tz):
    # Solve z_c such that the camera ray hits the world surface
    # z_w(x_w, y_w) = 1.5 + 0.05 sin(x_w / 0.2) + 0.04 cos(y_w / 0.15)
    # with the camera at (tx, 0, tz); fixed-point iteration suffices for
    # this gentle relief.
    ys, xs = _pixel_grids(H, W)
    z = np.full((H, W), 1.5, dtype=np.float64)
    for _ in range(4):
        x_w = (xs - cx) / fx * z + tx
        y_w = (ys - cy) / fx * z
        z = (1.5 + 0.05 * np.sin(x_w / 0.2) + 0.04 * np.cos(y_w / 0.15)) - tz
    return z


def _camera_model(H, W, B):
    """Pinhole model: ``(fx, cx, cy, tiled (B, 1, 4, 4) intrinsics)``."""
    fx = 0.8 * W
    cx, cy = (W - 1) / 2.0, (H - 1) / 2.0
    K = np.eye(4, dtype=np.float32)
    K[0, 0] = K[1, 1] = fx
    K[0, 2], K[1, 2] = cx, cy
    return fx, cx, cy, np.tile(K, (B, 1, 1, 1))


def _pan_poses(translations, B):
    """``(B, L, 4, 4)`` x/z-pan camera poses from per-frame ``(tx, tz)``."""
    poses = []
    for tx, tz in translations:
        P = np.eye(4, dtype=np.float32)
        P[0, 3] = tx
        P[2, 3] = tz
        poses.append(P)
    return np.tile(np.stack(poses), (B, 1, 1, 1))


def synthetic_sequence(
    B: int, L: int, H: int, W: int, seed: int = 0, speed: float = 1.0
):
    r"""Render a batch of synthetic sequences.

    ``speed`` scales the camera's per-frame translation (1.0 is a 5 mm/frame
    pan).

    Returns numpy ``(rgb (B, L, H, W, 3), depths (B, L, H, W, 1),
    intrinsics (B, 1, 4, 4), poses (B, L, 4, 4))``, all float32.
    """
    rng = np.random.RandomState(seed)
    fx, cx, cy, intrinsics = _camera_model(H, W, B)
    cam_ts = [(0.005 * speed * s, 0.002 * speed * s) for s in range(L)]
    depths = np.stack(
        [
            _render_depth(H, W, fx, cx, cy, tx, tz) + 0.0002 * rng.rand(H, W)
            for tx, tz in cam_ts
        ]
        * B
    ).reshape(B, L, H, W, 1).astype(np.float32)
    rgb = rng.rand(B, L, H, W, 3).astype(np.float32)
    poses = _pan_poses(cam_ts, B)
    return rgb, depths, intrinsics, poses
