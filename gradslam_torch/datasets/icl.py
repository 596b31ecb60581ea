r"""ICL-NUIM dataset loader of the PyTorch port.

Counterpart of ``gradslam_tpu/datasets/icl.py`` (reference
``gradslam/datasets/icl.py:17``): reads ``associations.txt`` and the
``*.gt.freiburg`` or ``*.gt.sim`` poses of ``living_room_trajX_frei_png``
trajectories. The reference's quirks are kept: intrinsics fx = 481.2,
**fy = -480** (negative), cx = 319.5, cy = 239.5; depth scale 1/5000; a
trajectory whose pose file is one pose short drops its last frame.
"""

from __future__ import annotations

import os
from typing import Optional, Union

import numpy as np

from .base import RGBDSequenceDataset, chunk_sequence
from .datautils import pointquaternion_to_homogeneous, scale_intrinsics
from .tum import _sequence_names

__all__ = ["ICL", "load_freiburg_poses", "load_sim_poses"]


def load_sim_poses(path: str) -> np.ndarray:
    """Parse a ``.gt.sim`` file: 3x4 pose blocks, 4 lines per pose (the last
    blank), padded with ``[0, 0, 0, 1]`` (reference icl.py:535-571)."""
    with open(path) as f:
        lines = f.readlines()
    poses = []
    block = []
    for line in lines:
        vals = [float(v) for v in line.strip().split()] if line.strip() else None
        if vals:
            block.append(vals)
            if len(block) == 3:
                mat = np.asarray(block, dtype=np.float32)
                poses.append(np.concatenate(
                    [mat, np.asarray([[0.0, 0.0, 0.0, 1.0]], dtype=np.float32)]))
                block = []
    return np.stack(poses)


def load_freiburg_poses(path: str) -> np.ndarray:
    """Parse a ``.gt.freiburg`` file (``t tx ty tz qx qy qz qw`` rows) into
    ``(N, 4, 4)`` float32 poses."""
    rows = []
    with open(path) as f:
        for line in f:
            if line.strip() and not line.startswith("#"):
                vals = [float(v) for v in line.strip().split()]
                rows.append(vals[1:8])  # drop the timestamp
    return pointquaternion_to_homogeneous(np.asarray(rows, dtype=np.float32))


class ICL(RGBDSequenceDataset):
    def __init__(
        self,
        basedir: str,
        trajectories: Union[tuple, str, None] = None,
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
        basedir = os.path.normpath(basedir)
        if not os.path.isdir(basedir):
            raise ValueError(f"basedir ({basedir}) does not exist.")
        trajectories = _sequence_names(basedir, trajectories)
        if len(trajectories) == 0:
            raise ValueError(f"No trajectories found in basedir ({basedir}).")

        # ICL intrinsics: note the NEGATIVE fy (reference icl.py:379-381).
        K = np.eye(4, dtype=np.float32)
        K[0, 0], K[1, 1], K[0, 2], K[1, 2] = 481.2, -480.0, 319.5, 239.5
        self._intrinsics = scale_intrinsics(K, height / 480.0, width / 640.0)

        for traj in trajectories:
            trajdir = os.path.join(basedir, traj)
            assoc_path = os.path.join(trajdir, "associations.txt")
            if not os.path.isfile(assoc_path):
                raise ValueError(f"Missing associations.txt in {trajdir}.")
            depth_rel, color_rel = [], []
            with open(assoc_path) as f:
                for line in f:
                    if not line.strip():
                        continue
                    fields = line.strip().split()
                    # format: depth_t depth_path rgb_t rgb_path
                    depth_rel.append(fields[1])
                    color_rel.append(fields[3])

            pose_file = None
            for fname in sorted(os.listdir(trajdir)):
                if fname.endswith(".gt.freiburg"):
                    pose_file, fmt = os.path.join(trajdir, fname), "freiburg"
                    break
                if fname.endswith(".gt.sim"):
                    pose_file, fmt = os.path.join(trajdir, fname), "sim"
            if pose_file is None:
                raise ValueError(f"No groundtruth pose file found in {trajdir}.")
            poses = (load_freiburg_poses(pose_file) if fmt == "freiburg"
                     else load_sim_poses(pose_file))

            n = min(len(color_rel), len(poses))  # trajectory 0 drops its last frame
            color_paths = [os.path.join(trajdir, p) for p in color_rel[:n]]
            depth_paths = [os.path.join(trajdir, p) for p in depth_rel[:n]]

            for chunk in chunk_sequence(n, seqlen, dilation, stride, start, end):
                self.samples.append(dict(
                    color_paths=[color_paths[i] for i in chunk],
                    depth_paths=[depth_paths[i] for i in chunk],
                    poses=[poses[i] for i in chunk],
                    name=traj,
                ))

    def intrinsics_for(self, idx: int) -> np.ndarray:
        """Fixed ICL pinhole intrinsics (4x4, fy negative: the reference's
        quirk, icl.py:379-381), pre-scaled to the target resolution."""
        return self._intrinsics
