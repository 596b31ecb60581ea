r"""TUM RGB-D dataset loader of the PyTorch port.

Counterpart of ``gradslam_tpu/datasets/tum.py`` (reference
``gradslam/datasets/tum.py:17``): associates the unsynchronized rgb, depth
and groundtruth streams by timestamp (greedy by smallest gap, at most
0.02 s), chunks by ``seqlen``/``dilation``/``stride``/``start``/``end``,
resizes to ``height x width``, scales depth by 1/5000 to metres, uses the
fixed Freiburg intrinsics fx = fy = 525, cx = 319.5, cy = 239.5 scaled to
the target size, and re-bases each chunk's poses so its frame 0 is the
identity. Samples are CPU tensors (see
:class:`~gradslam_torch.datasets.base.RGBDSequenceDataset`).
"""

from __future__ import annotations

import os
from typing import Optional, Union

import numpy as np

from . import tumutils
from .base import RGBDSequenceDataset, chunk_sequence
from .datautils import pointquaternion_to_homogeneous, scale_intrinsics

__all__ = ["TUM"]


def _sequence_names(basedir: str, sequences) -> tuple:
    """``sequences`` as a tuple of directory names: a name, a ``.txt`` file
    listing names, or None for every directory under ``basedir``."""
    if isinstance(sequences, str):
        if sequences.endswith(".txt"):
            with open(sequences) as f:
                sequences = tuple(line.strip() for line in f if line.strip() and line[0] != "#")
        else:
            sequences = (sequences,)
    if sequences is None:
        sequences = tuple(d for d in sorted(os.listdir(basedir))
                          if os.path.isdir(os.path.join(basedir, d)))
    return sequences


class TUM(RGBDSequenceDataset):
    def __init__(
        self,
        basedir: str,
        sequences: Union[tuple, str, None] = None,
        seqlen: int = 4,
        dilation: Optional[int] = None,
        stride: Optional[int] = None,
        start: Optional[int] = None,
        end: Optional[int] = None,
        height: int = 480,
        width: int = 640,
        channels_first: bool = False,
        normalize_color: bool = False,
        return_depth: bool = True,
        return_intrinsics: bool = True,
        return_pose: bool = True,
        return_transform: bool = True,
        return_names: bool = True,
        return_timestamps: bool = True,
        loader: str = "cv2",
        pin_memory: bool = False,
    ):
        super().__init__(
            seqlen=seqlen, height=height, width=width, channels_first=channels_first,
            normalize_color=normalize_color, return_depth=return_depth,
            return_intrinsics=return_intrinsics, return_pose=return_pose,
            return_transform=return_transform, return_names=return_names,
            loader=loader, depth_scale=5000.0, pin_memory=pin_memory,
        )
        self.return_timestamps = return_timestamps
        basedir = os.path.normpath(basedir)
        if not os.path.isdir(basedir):
            raise ValueError(f"basedir ({basedir}) does not exist.")
        sequences = _sequence_names(basedir, sequences)
        if len(sequences) == 0:
            raise ValueError(f"No sequences found in basedir ({basedir}).")

        # TUM Freiburg default intrinsics at 640x480 (reference tum.py:338-340).
        K = np.eye(4, dtype=np.float32)
        K[0, 0], K[1, 1], K[0, 2], K[1, 2] = 525.0, 525.0, 319.5, 239.5
        self._intrinsics = scale_intrinsics(K, height / 480.0, width / 640.0)

        for seq in sequences:
            seqdir = os.path.join(basedir, seq)
            for req in ("rgb.txt", "depth.txt", "groundtruth.txt"):
                if not os.path.isfile(os.path.join(seqdir, req)):
                    raise ValueError(f"Missing {req} in sequence dir {seqdir}.")
            rgb_list = tumutils.read_file_list(os.path.join(seqdir, "rgb.txt"))
            depth_list = tumutils.read_file_list(os.path.join(seqdir, "depth.txt"))
            gt_list = tumutils.read_file_list(os.path.join(seqdir, "groundtruth.txt"))

            # rgb <-> depth, then (rgb, depth) <-> groundtruth
            matches_rd = tumutils.associate(rgb_list, depth_list, 0.0, 0.02)
            rgb_stamps = {a: b for a, b in matches_rd}
            matches_rg = tumutils.associate(
                {a: rgb_list[a] for a, _ in matches_rd}, gt_list, 0.0, 0.02)
            associations = [(a, rgb_stamps[a], g) for a, g in matches_rg]  # (rgb, depth, gt)

            color_paths = [os.path.join(seqdir, rgb_list[a][0]) for a, _, _ in associations]
            depth_paths = [os.path.join(seqdir, depth_list[d][0]) for _, d, _ in associations]
            pq = np.asarray([[float(v) for v in gt_list[g]] for _, _, g in associations],
                            dtype=np.float32)
            poses = pointquaternion_to_homogeneous(pq)
            stamps = np.asarray(associations, dtype=np.float64)

            for chunk in chunk_sequence(len(associations), seqlen, dilation, stride, start, end):
                self.samples.append(dict(
                    color_paths=[color_paths[i] for i in chunk],
                    depth_paths=[depth_paths[i] for i in chunk],
                    poses=[poses[i] for i in chunk],
                    name=seq,
                    timestamps=stamps[chunk],
                    return_timestamps=return_timestamps,
                ))

    def intrinsics_for(self, idx: int) -> np.ndarray:
        """Fixed TUM pinhole intrinsics (4x4), pre-scaled to the target
        resolution (reference tum.py:338-350)."""
        return self._intrinsics
