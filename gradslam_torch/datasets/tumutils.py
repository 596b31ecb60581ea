r"""TUM RGB-D benchmark association helpers of the PyTorch port (numpy
only).

Counterpart of ``gradslam_tpu/datasets/tumutils.py`` (``read_file_list``
:21, ``associate`` :36, ``transform44`` :63, ``read_trajectory`` :87), the
same code: the port keeps its own copy because importing ``gradslam_tpu``
imports JAX. As there, the reference's latent bugs (``sys`` used without
import, the malformed tuple in ``transform44``'s small-norm branch) are
fixed; the reference line numbers below are gradslam's
``datasets/tumutils.py``.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

__all__ = ["read_file_list", "associate", "read_trajectory", "transform44"]

_EPS = np.finfo(float).eps * 4.0


def read_file_list(filename: str) -> Dict[float, List[str]]:
    r"""Parse a TUM-format file into ``{timestamp: [data...]}``. Lines starting
    with '#' are ignored."""
    with open(filename) as f:
        text = f.read()
    entries = {}
    for line in text.replace(",", " ").replace("\t", " ").split("\n"):
        if line.startswith("#"):
            continue
        fields = [v.strip() for v in line.split(" ") if v.strip() != ""]
        if len(fields) > 1:
            entries[float(fields[0])] = fields[1:]
    return entries


def associate(
    first_list: Dict[float, List[str]],
    second_list: Dict[float, List[str]],
    offset: float,
    max_difference: float,
) -> List[Tuple[float, float]]:
    r"""Greedy nearest-timestamp matching between two stamped dictionaries
    (reference tumutils.py:182-216)."""
    first_keys = set(first_list.keys())
    second_keys = set(second_list.keys())
    potential_matches = [
        (abs(a - (b + offset)), a, b)
        for a in first_keys
        for b in second_keys
        if abs(a - (b + offset)) < max_difference
    ]
    potential_matches.sort()
    matches = []
    for _, a, b in potential_matches:
        if a in first_keys and b in second_keys:
            first_keys.remove(a)
            second_keys.remove(b)
            matches.append((a, b))
    matches.sort()
    return matches


def transform44(stamped_pose) -> np.ndarray:
    r"""Convert a stamped ``(stamp, tx, ty, tz, qx, qy, qz, qw)`` tuple to a
    4x4 homogeneous matrix (reference tumutils.py:57-93, small-norm branch
    fixed)."""
    t = np.asarray(stamped_pose[1:4], dtype=np.float64)
    q = np.asarray(stamped_pose[4:8], dtype=np.float64)
    nq = float(np.dot(q, q))
    if nq < _EPS:
        out = np.eye(4)
        out[:3, 3] = t
        return out
    q = q * np.sqrt(2.0 / nq)
    q = np.outer(q, q)
    return np.array(
        [
            [1.0 - q[1, 1] - q[2, 2], q[0, 1] - q[2, 3], q[0, 2] + q[1, 3], t[0]],
            [q[0, 1] + q[2, 3], 1.0 - q[0, 0] - q[2, 2], q[1, 2] - q[0, 3], t[1]],
            [q[0, 2] - q[1, 3], q[1, 2] + q[0, 3], 1.0 - q[0, 0] - q[1, 1], t[2]],
            [0.0, 0.0, 0.0, 1.0],
        ],
        dtype=np.float64,
    )


def read_trajectory(filename: str, matrix: bool = True) -> Dict[float, np.ndarray]:
    r"""Read a TUM trajectory file into ``{stamp: 4x4 matrix}`` (or stamped
    tuples when ``matrix=False``); NaN rows are skipped with a warning
    (reference tumutils.py:95-144, sys-import bug fixed)."""
    import warnings

    with open(filename) as f:
        lines = f.read().replace(",", " ").replace("\t", " ").split("\n")
    rows = [
        [float(v.strip()) for v in line.split(" ") if v.strip() != ""]
        for line in lines
        if len(line) > 0 and line[0] != "#"
    ]
    rows = [r for r in rows if len(r) > 0]
    traj = {}
    for row in rows:
        if np.any(np.isnan(row)):
            warnings.warn(f"input file {filename} has NaN rows; skipping")
            continue
        if matrix:
            traj[row[0]] = transform44(row[0:8])
        else:
            traj[row[0]] = np.asarray(row[1:8])
    return traj
