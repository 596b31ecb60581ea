r"""Checkpoint and resume of SLAM state for the PyTorch port.

Counterpart of ``gradslam_tpu/utils/checkpoint.py`` (``save_state`` :23,
``load_state`` :51): the state of an online run is the map and the
trajectory, written to one ``.npz`` with the same keys (``points``,
``num_points``, optional ``normals``, ``colors``, ``features``,
``num_dropped``, ``poses``) and replaced atomically. A file written by
either package loads in the other, which carries a map across between them
(as :mod:`gradslam_torch.interop` does in memory).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..interop import pointclouds_from_numpy
from ..structures.pointclouds import Pointclouds

__all__ = ["save_state", "load_state"]


def _numpy(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def save_state(path: str, pointclouds: Pointclouds, poses: Optional[torch.Tensor] = None):
    r"""Serialize SLAM state (map buffers and trajectory) to ``path`` (``.npz``
    added when missing) as a compressed ``.npz``, replacing an earlier file
    atomically: periodic checkpoints overwrite one file, and a crash during
    the write must not truncate the only resumable state."""
    arrays = {"points": _numpy(pointclouds.points), "num_points": _numpy(pointclouds.num_points)}
    for name in ("normals", "colors", "features", "num_dropped"):
        val = getattr(pointclouds, name)
        if val is not None:
            arrays[name] = _numpy(val)
    if poses is not None:
        arrays["poses"] = _numpy(poses)
    dest = path if path.endswith(".npz") else path + ".npz"
    tmp = dest + ".tmp"
    try:
        with open(tmp, "wb") as f:
            np.savez_compressed(f, **arrays)
        os.replace(tmp, dest)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load_state(
    path: str, device: Union[str, torch.device] = "cuda"
) -> Tuple[Pointclouds, Optional[torch.Tensor]]:
    r"""Load SLAM state saved by :func:`save_state` (or by the JAX
    package's). Returns ``(Pointclouds, poses or None)`` on ``device``, the
    card unless the caller asks for another; buffers are float32 and
    counters int64, as the port's structures hold them."""
    if not path.endswith(".npz") and os.path.exists(path + ".npz"):
        path = path + ".npz"
    with np.load(path) as data:
        fields = {k: data[k] if k in data else None
                  for k in ("normals", "colors", "features", "num_dropped")}
        pc = pointclouds_from_numpy(data["points"], data["num_points"], device=device, **fields)
        poses = (torch.tensor(np.asarray(data["poses"], dtype=np.float32), device=device)
                 if "poses" in data else None)
    return pc, poses
