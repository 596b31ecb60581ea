r"""Synthetic RGB-D sequences.

Counterpart of ``gradslam_tpu/datasets/synthetic.py``: a procedurally
rendered static scene — a gently wavy wall observed by a slowly translating
camera with mm-scale sensor noise (``synthetic_sequence``), or by a fast,
accelerating camera with heavy noise and outlier patches (``hard_sequence``).
The same seed gives the same arrays as the JAX package's generators, so both
packages can be driven with one clip. The generators return numpy arrays;
:class:`SyntheticRGBD` serves them as a dataset of CPU tensors, as the
TUM, ICL and ScanNet loaders do. The port cannot import the original:
importing ``gradslam_tpu`` imports JAX.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from .base import RGBDSequenceDataset
from .datautils import channels_first as to_channels_first
from .datautils import poses_to_transforms

__all__ = ["SyntheticRGBD", "hard_sequence", "synthetic_sequence"]


@lru_cache(maxsize=8)
def _pixel_grids(H, W):
    return np.meshgrid(np.arange(H), np.arange(W), indexing="ij")


def _render_depth(H, W, fx, cx, cy, tx, tz, fy=None):
    # Solve z_c such that the camera ray hits the world surface
    # z_w(x_w, y_w) = 1.5 + 0.05 sin(x_w / 0.2) + 0.04 cos(y_w / 0.15)
    # with the camera at (tx, 0, tz); fixed-point iteration suffices for
    # this gentle relief. ``fy`` defaults to ``fx`` (square pixels); a
    # negative ``fy`` (ICL's) flips the image rows.
    fy = fx if fy is None else fy
    ys, xs = _pixel_grids(H, W)
    z = np.full((H, W), 1.5, dtype=np.float64)
    for _ in range(4):
        x_w = (xs - cx) / fx * z + tx
        y_w = (ys - cy) / fy * z
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


def hard_sequence(
    B: int,
    L: int,
    H: int,
    W: int,
    seed: int = 0,
    speed: float = 12.0,
    noise_sigma: float = 0.005,
    outlier_frac: float = 0.12,
    outlier_mag: float = 0.35,
):
    r"""Render the hard tracked-SLAM clip (``gradslam_tpu/datasets/
    synthetic.py:92-156``): the same scene as :func:`synthetic_sequence`,
    seen by an accelerating camera (``speed=12`` is a 6 cm/frame pan,
    modulated by ``s + 0.3 sin(s / 2)``), with Gaussian depth noise of
    ``noise_sigma`` metres and, on every frame, 8 random rectangles covering
    about ``outlier_frac`` of the pixels, biased by up to ``outlier_mag``
    metres. The ``RandomState`` draws come in the JAX package's order, so a
    seed gives bit-identical arrays. Ground-truth poses are exact.

    Same return contract as :func:`synthetic_sequence`.
    """
    rng = np.random.RandomState(seed)
    fx, cx, cy, intrinsics = _camera_model(H, W, B)

    def cam_t(s):
        u = s + 0.3 * np.sin(s / 2.0)
        return 0.005 * speed * u, 0.002 * speed * u

    depths = np.empty((B, L, H, W, 1), dtype=np.float32)
    for b in range(B):
        for s in range(L):
            tx, tz = cam_t(s)
            z = _render_depth(H, W, fx, cx, cy, tx, tz)
            z = z + noise_sigma * rng.randn(H, W)
            if outlier_frac > 0 and outlier_mag != 0:
                n_patches = 8
                target = outlier_frac * H * W / n_patches
                ph = max(2, int(np.sqrt(target * H / W)))
                pw = max(2, int(np.sqrt(target * W / H)))
                for _ in range(n_patches):
                    y0 = rng.randint(0, max(1, H - ph))
                    x0 = rng.randint(0, max(1, W - pw))
                    z[y0:y0 + ph, x0:x0 + pw] += outlier_mag * (2.0 * rng.rand() - 1.0)
            depths[b, s, ..., 0] = z.astype(np.float32)
    rgb = rng.rand(B, L, H, W, 3).astype(np.float32)
    poses = _pan_poses([cam_t(s) for s in range(L)], B)
    return rgb, depths, intrinsics, poses


class SyntheticRGBD(RGBDSequenceDataset):
    r"""Dataset over :func:`synthetic_sequence`: ``num_sequences`` samples,
    sample ``idx`` rendered from seed ``seed + idx``, each ``(colors,
    depths, intrinsics, poses, transforms, name)`` as CPU tensors (colours
    in 0-255 unless ``normalize_color``), the loaders' contract and the JAX
    package's tuple (``gradslam_tpu/datasets/synthetic.py:159``)."""

    def __init__(
        self,
        num_sequences: int = 1,
        seqlen: int = 10,
        height: int = 240,
        width: int = 320,
        channels_first: bool = False,
        normalize_color: bool = False,
        seed: int = 0,
    ):
        super().__init__(seqlen=seqlen, height=height, width=width,
                         channels_first=channels_first, normalize_color=normalize_color)
        self.num_sequences = num_sequences
        self.seed = seed

    def __len__(self) -> int:
        return self.num_sequences

    def __getitem__(self, idx: int):
        if not 0 <= idx < self.num_sequences:
            raise IndexError(idx)
        rgb, depths, intrinsics, poses = synthetic_sequence(
            1, self.seqlen, self.height, self.width, seed=self.seed + idx)
        colors = rgb[0] * (1.0 if self.normalize_color else 255.0)
        depths = depths[0]
        if self.channels_first:
            colors, depths = to_channels_first(colors), to_channels_first(depths)
        transforms = np.stack(poses_to_transforms(poses[0])).astype(np.float32)
        return (
            self._tensor(colors.astype(np.float32)),
            self._tensor(depths),
            self._tensor(intrinsics[0, 0]),
            self._tensor(poses[0]),
            self._tensor(transforms),
            f"synthetic_{self.seed + idx}",
        )
