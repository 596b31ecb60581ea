r"""TUM-format trajectory import and export of the PyTorch port (numpy only).

Counterpart of ``gradslam_tpu/utils/trajectory_io.py``
(``_rotation_matrix_to_quaternion`` :18, ``save_trajectory_tum`` :48,
``load_trajectory_tum`` :69), for the TUM RGB-D benchmark's tools. Format:
one line per pose, ``timestamp tx ty tz qx qy qz qw``. The port writes nine
decimals where the JAX package writes six, so that a float32 trajectory
reads back within 1e-6 (six decimals of a quaternion move a rotation entry
by up to about 2e-6); each package reads the other's files.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..datasets.datautils import pointquaternion_to_homogeneous

__all__ = ["save_trajectory_tum", "load_trajectory_tum"]


def _rotation_matrix_to_quaternion(R: np.ndarray) -> np.ndarray:
    """(3, 3) rotation -> (x, y, z, w) quaternion (Shepperd's method)."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    elif R[0, 0] > R[1, 1] and R[0, 0] > R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        w = (R[2, 1] - R[1, 2]) / s
        x = 0.25 * s
        y = (R[0, 1] + R[1, 0]) / s
        z = (R[0, 2] + R[2, 0]) / s
    elif R[1, 1] > R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        w = (R[0, 2] - R[2, 0]) / s
        x = (R[0, 1] + R[1, 0]) / s
        y = 0.25 * s
        z = (R[1, 2] + R[2, 1]) / s
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
        w = (R[1, 0] - R[0, 1]) / s
        x = (R[0, 2] + R[2, 0]) / s
        y = (R[1, 2] + R[2, 1]) / s
        z = 0.25 * s
    return np.asarray([x, y, z, w])


def save_trajectory_tum(path: str, poses, timestamps: Optional[Sequence[float]] = None):
    r"""Write ``(L, 4, 4)`` poses (numpy or a tensor on any device) as a TUM
    trajectory file (compatible with the benchmark's evaluate_ate.py and
    evaluate_rpe.py); the stamps default to ``0, 1, 2, ...``."""
    if hasattr(poses, "detach"):
        poses = poses.detach().cpu().numpy()
    poses = np.asarray(poses, dtype=np.float64)
    if poses.ndim != 3 or poses.shape[-2:] != (4, 4):
        raise ValueError(f"poses must have shape (L, 4, 4). Got {poses.shape}.")
    L = poses.shape[0]
    stamps = np.arange(L, dtype=np.float64) if timestamps is None else timestamps
    with open(path, "w") as f:
        f.write("# timestamp tx ty tz qx qy qz qw\n")
        for i in range(L):
            t = poses[i, :3, 3]
            q = _rotation_matrix_to_quaternion(poses[i, :3, :3])
            f.write(f"{float(stamps[i]):.6f} " + " ".join(f"{v:.9f}" for v in (*t, *q)) + "\n")


def load_trajectory_tum(path: str):
    r"""Read a TUM trajectory file; returns ``(timestamps (L,) float64,
    poses (L, 4, 4) float32)`` numpy arrays."""
    stamps, rows = [], []
    with open(path) as f:
        for line in f:
            if not line.strip() or line.startswith("#"):
                continue
            vals = [float(v) for v in line.split()]
            stamps.append(vals[0])
            rows.append(vals[1:8])
    poses = pointquaternion_to_homogeneous(np.asarray(rows, dtype=np.float32))
    return np.asarray(stamps), poses
