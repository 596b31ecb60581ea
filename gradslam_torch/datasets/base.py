r"""Shared machinery of the port's RGB-D sequence datasets.

Counterpart of ``gradslam_tpu/datasets/base.py`` (``chunk_sequence`` :19,
``resize_color`` :56, ``resize_depth`` :71, ``RGBDSequenceDataset`` :82).
A dataset here is a ``torch.utils.data.Dataset`` whose samples are CPU
tensors (pinned where the caller asks); the SLAM entry points put them on
the card. Frames are read with the port's own decoder
(:mod:`~gradslam_torch.datasets.frameio`, a C++ library built at first use)
and resized without cv2:

- depth and labels: cv2's ``INTER_NEAREST``, source index
  ``floor(dst * (1 / (dst / src)))`` clamped to the last pixel, exactly;
- colour: cv2's ``INTER_LINEAR`` (half-pixel centres, edge pixels clamped,
  no antialiasing) in float64, rounded half up to 8 bits. cv2 rounds through
  11-bit fixed-point weights, so the two may differ by one level; at an exact
  2x reduction cv2 averages 2x2 blocks and the two agree bit for bit.
"""

from __future__ import annotations

import os
import warnings
from typing import List, Optional, Tuple

import numpy as np
import torch

from .datautils import channels_first as to_channels_first
from .datautils import poses_to_transforms
from .frameio import FrameLoader, read_image

__all__ = [
    "RGBDSequenceDataset",
    "chunk_sequence",
    "resize_color",
    "resize_depth",
    "resize_nearest",
]


def chunk_sequence(
    num_frames: int,
    seqlen: int,
    dilation: Optional[int],
    stride: Optional[int],
    start: Optional[int],
    end: Optional[int],
) -> List[List[int]]:
    r"""Frame-index chunking shared by all datasets (reference tum.py:46-57
    diagram): sequences of ``seqlen`` frames, ``dilation`` skipped frames
    between consecutive frames, ``stride`` frames between sequence starts.
    """
    start = 0 if start is None else start
    end = num_frames if end is None else min(end, num_frames)
    dilation = 0 if dilation is None else dilation
    stride = seqlen * (dilation + 1) if stride is None else stride
    # Strictly positive, as in the JAX package: seqlen=0 or stride=0 would
    # never advance.
    if seqlen < 1:
        raise ValueError(f"seqlen must be positive. Got {seqlen}.")
    if dilation < 0:
        raise ValueError(f"dilation must be non-negative. Got {dilation}.")
    if stride < 1:
        raise ValueError(f"stride must be positive. Got {stride}.")
    if start < 0:
        raise ValueError(f"start must be non-negative. Got {start}.")
    if start >= end:
        raise ValueError(f"start ({start}) must be smaller than end ({end}).")
    span = (seqlen - 1) * (dilation + 1) + 1
    chunks = []
    s = start
    while s + span <= end:
        chunks.append([s + i * (dilation + 1) for i in range(seqlen)])
        s += stride
    return chunks


def _nearest_index(src: int, dst: int) -> np.ndarray:
    """cv2's ``INTER_NEAREST`` source indices: ``floor(x * (1 / (dst /
    src)))`` in double precision, clamped to ``src - 1``."""
    inv = 1.0 / (dst / src)
    return np.minimum(np.floor(np.arange(dst) * inv).astype(np.int64), src - 1)


def resize_nearest(image: np.ndarray, height: int, width: int) -> np.ndarray:
    """Nearest-neighbour resize of ``(H, W, *C)`` to ``(height, width, *C)``
    (cv2's ``INTER_NEAREST``), any dtype."""
    image = np.asarray(image)
    if image.shape[:2] == (height, width):
        return image
    rows = _nearest_index(image.shape[0], height)
    cols = _nearest_index(image.shape[1], width)
    return image[rows[:, None], cols[None, :]]


def _linear_taps(src: int, dst: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """cv2's ``INTER_LINEAR`` taps along one axis: the left source index,
    the right one and the right weight, half-pixel centres, weight 0 at
    the clamped edges."""
    f = (np.arange(dst) + 0.5) * (src / dst) - 0.5
    lo = np.floor(f).astype(np.int64)
    w = f - lo
    w = np.where((lo < 0) | (lo >= src - 1), 0.0, w)
    lo = np.clip(lo, 0, src - 1)
    return lo, np.minimum(lo + 1, src - 1), w


def resize_color(color: np.ndarray, height: int, width: int, normalize: bool) -> np.ndarray:
    r"""Resize (bilinear) and optionally normalize a colour image to float32
    (``gradslam_tpu/datasets/base.py:56``, reference tum.py:436-457). An
    8-bit image is resized to 8 bits, as cv2 does, then converted."""
    color = np.asarray(color)
    if color.shape[0] != height or color.shape[1] != width:
        r0, r1, wy = _linear_taps(color.shape[0], height)
        c0, c1, wx = _linear_taps(color.shape[1], width)
        x = color.astype(np.float64)
        wx = wx[:, None] if x.ndim == 3 else wx
        top = x[r0][:, c0] * (1.0 - wx) + x[r0][:, c1] * wx
        bottom = x[r1][:, c0] * (1.0 - wx) + x[r1][:, c1] * wx
        wy = wy.reshape((-1,) + (1,) * (x.ndim - 1))
        out = top * (1.0 - wy) + bottom * wy
        if np.issubdtype(color.dtype, np.integer):
            info = np.iinfo(color.dtype)
            out = np.clip(np.floor(out + 0.5), info.min, info.max).astype(color.dtype)
        color = out
    color = np.asarray(color, dtype=np.float32)
    if normalize:
        color = color / 255.0
    return color


def resize_depth(depth: np.ndarray, height: int, width: int, scale: float) -> np.ndarray:
    r"""Resize (nearest) and scale a depth image to metres, float32
    (``gradslam_tpu/datasets/base.py:71``, reference tum.py:459-481)."""
    depth = resize_nearest(np.asarray(depth, dtype=np.float32), height, width)
    return depth / scale


class RGBDSequenceDataset(torch.utils.data.Dataset):
    r"""Base: stores per-sequence frame paths and poses, serves chunked
    samples as CPU tensors.

    Subclasses fill ``self.samples``, a list of dicts with keys
    ``color_paths``, ``depth_paths``, optional ``poses`` (list of 4x4),
    ``name`` and optional ``timestamps``, and define
    :meth:`intrinsics_for`.

    ``loader``: ``'cv2'`` reads and decodes a sample's frames one after the
    other and resizes them as cv2 does (:func:`resize_color`,
    :func:`resize_depth`); ``'native'`` decodes them on the threads of a
    :class:`~gradslam_torch.datasets.frameio.FrameLoader`, with the JAX
    package's native library's arithmetic (bilinear colours left unrounded,
    depth times ``1 / depth_scale``). Both decode PNG through the port's
    C++ library, built at first use; at the stored size both give the same
    colours. Where a frame fails to decode, ``'native'`` warns and reads the
    sample as ``'cv2'`` does, as the JAX package's does. Where the library
    cannot be built, both raise: unlike the JAX package, which warns and
    reads through cv2 when its native library is missing, nothing falls
    back to a slower decoder. ``pin_memory``: pin the returned tensors
    (needs a CUDA build of torch).
    """

    def __init__(
        self,
        seqlen: int = 4,
        height: int = 480,
        width: int = 640,
        channels_first: bool = False,
        normalize_color: bool = False,
        return_depth: bool = True,
        return_intrinsics: bool = True,
        return_pose: bool = True,
        return_transform: bool = True,
        return_names: bool = True,
        depth_scale: float = 5000.0,
        loader: str = "cv2",
        pin_memory: bool = False,
    ):
        if loader not in ("cv2", "native"):
            raise ValueError(f"loader must be 'cv2' or 'native'. Got {loader!r}.")
        self.seqlen = seqlen
        self.height = height
        self.width = width
        self.channels_first = channels_first
        self.normalize_color = normalize_color
        self.return_depth = return_depth
        self.return_intrinsics = return_intrinsics
        self.return_pose = return_pose
        self.return_transform = return_transform
        self.return_names = return_names
        self.depth_scale = depth_scale
        self.loader = loader
        self.pin_memory = pin_memory
        self.samples: List[dict] = []

    def __len__(self) -> int:
        return len(self.samples)

    def intrinsics_for(self, idx: int) -> np.ndarray:
        raise NotImplementedError

    def _load_native(self, sample: dict):
        """The sample's ``(colors, depths)`` through a
        :class:`~gradslam_torch.datasets.frameio.FrameLoader` (a thread a
        frame, up to one a core), or None when a frame fails to decode."""
        cpaths, dpaths = list(sample["color_paths"]), list(sample["depth_paths"])
        loader = FrameLoader(self.height, self.width, self.depth_scale,
                             normalize_color=self.normalize_color,
                             num_threads=min(len(cpaths), os.cpu_count() or 1))
        try:
            loader.submit_sequence(cpaths, dpaths)
            frames = [loader.fetch(i) for i in range(len(cpaths))]
        except IOError:
            warnings.warn(f"native frameio failed to decode a frame of {sample['name']!r}; "
                          "falling back to the cv2 path for this sample.")
            return None
        finally:
            loader.close()
        return (np.stack([rgb for rgb, _ in frames]),
                np.stack([depth for _, depth in frames])[..., None])

    def _load_frames(self, sample: dict) -> Tuple[np.ndarray, np.ndarray]:
        """The sample's frames: ``colors (L, H, W, 3)``, ``depths (L, H, W,
        1)`` float32, channels-first when the dataset is."""
        loaded = self._load_native(sample) if self.loader == "native" else None
        if loaded is None:
            paths = list(sample["color_paths"]) + list(sample["depth_paths"])
            images = [read_image(p) for p in paths]
            n = len(sample["color_paths"])
            loaded = (
                np.stack([resize_color(im, self.height, self.width, self.normalize_color)
                          for im in images[:n]]),
                np.stack([resize_depth(im, self.height, self.width, self.depth_scale)
                          for im in images[n:]])[..., None],
            )
        colors, depths = loaded
        if self.channels_first:
            colors = to_channels_first(colors)
            depths = to_channels_first(depths)
        return colors, depths

    def _tensor(self, array: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(array))
        return t.pin_memory() if self.pin_memory else t

    def _pose_outputs(self, poses: np.ndarray) -> list:
        """Poses re-based so frame 0 is the identity (reference
        tum.py:497-499) and the frame-to-frame transforms, as asked."""
        poses = (np.linalg.inv(poses[0:1]) @ poses).astype(np.float32)
        out = []
        if self.return_pose:
            out.append(self._tensor(poses))
        if self.return_transform:
            out.append(self._tensor(np.stack(poses_to_transforms(poses)).astype(np.float32)))
        return out

    def __getitem__(self, idx: int):
        sample = self.samples[idx]
        colors, depths = self._load_frames(sample)
        output = [self._tensor(colors)]
        if self.return_depth:
            output.append(self._tensor(depths))
        if self.return_intrinsics:
            output.append(self._tensor(np.asarray(self.intrinsics_for(idx), dtype=np.float32)))
        if self.return_pose or self.return_transform:
            if "poses" not in sample:
                raise ValueError(
                    f"{type(self).__name__} provides no poses for this sequence; "
                    "construct it with return_pose=False and return_transform=False.")
            output += self._pose_outputs(np.stack(sample["poses"]).astype(np.float32))
        if self.return_names:
            output.append(sample["name"])
        if "timestamps" in sample and sample.get("return_timestamps", False):
            output.append(self._tensor(sample["timestamps"]))
        return tuple(output)
