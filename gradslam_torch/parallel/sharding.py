r"""Data-parallel SLAM across processes on ``torch.distributed``.

Counterpart of ``gradslam_tpu/parallel/sharding.py``. Batched SLAM is
embarrassingly data-parallel: each sequence of the batch builds its own map.
JAX shards the batch axis of every array over a ``Mesh`` and lets XLA
partition the program; here each process (one rank a card, or a CPU rank
under gloo) runs the pipeline on its contiguous block of the batch and the
results are all-gathered, so every rank returns the whole batch's maps and
poses, as JAX's caller gets them. The gather is differentiable: a loss over
the gathered batch backpropagates to each rank's own depths and intrinsics
(:func:`~gradslam_torch.parallel.collectives.gather_batch`).

The process group is the caller's: :func:`make_mesh` builds a
``DeviceMesh`` over the default group that
``torch.distributed.init_process_group`` initialised in every process, and
refuses to run without one.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..structures.pointclouds import Pointclouds
from ..structures.rgbdimages import RGBDImages
from . import collectives

__all__ = [
    "make_mesh",
    "shard_frames",
    "shard_pointclouds",
    "batch_sharding",
    "map_sharded_spec",
    "DataParallelSLAM",
]


def make_mesh(devices: Optional[Sequence[int]] = None, axis_name: str = "data", *,
              device_type: str = "cuda") -> DeviceMesh:
    r"""A 1-D ``DeviceMesh`` named ``axis_name`` over the ranks ``devices``
    (default: every rank of the default process group), on the card
    (``device_type='cuda'``, NCCL) unless the caller asks for the CPU
    (``device_type='cpu'``, gloo). Every rank of the default group must call
    it. Raises when no process group is initialised: the port never builds
    a one-process world by itself."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "make_mesh needs a default process group: call "
            "torch.distributed.init_process_group(backend, init_method=..., rank=..., "
            "world_size=...) in every process first.")
    ranks = list(range(dist.get_world_size())) if devices is None else [int(r) for r in devices]
    return DeviceMesh(device_type, torch.tensor(ranks, dtype=torch.int64),
                      mesh_dim_names=(axis_name,))


def _placements(mesh: DeviceMesh, axis_name: str, dim: int):
    from torch.distributed.tensor import Replicate, Shard

    if axis_name not in mesh.mesh_dim_names:
        raise ValueError(f"mesh has no axis {axis_name!r} (axes: {mesh.mesh_dim_names}).")
    return tuple(Shard(dim) if name == axis_name else Replicate()
                 for name in mesh.mesh_dim_names)


def batch_sharding(mesh: DeviceMesh, axis_name: str = "data"):
    r"""Placements that split the leading (batch) axis across the mesh axis
    ``axis_name`` (``Shard(0)``; ``Replicate()`` on any other axis), for
    ``torch.distributed.tensor.distribute_tensor``."""
    return _placements(mesh, axis_name, 0)


def map_sharded_spec(mesh: DeviceMesh, axis_name: str = "data"):
    r"""Placements for the map-point (capacity) axis: ``points (B, CAP,
    3)`` split along CAP (``Shard(1)``)."""
    return _placements(mesh, axis_name, 1)


def _block(mesh: DeviceMesh, axis_name: str, B: int) -> slice:
    """This rank's contiguous block of a batch of ``B``."""
    if axis_name not in mesh.mesh_dim_names:
        raise ValueError(f"mesh has no axis {axis_name!r} (axes: {mesh.mesh_dim_names}).")
    n = mesh.size(mesh.mesh_dim_names.index(axis_name))
    if B % n != 0:
        raise ValueError(f"Batch size ({B}) must be divisible by the mesh size ({n}).")
    i = mesh.get_local_rank(axis_name)
    return slice(i * (B // n), (i + 1) * (B // n))


def shard_frames(frames: RGBDImages, mesh: DeviceMesh, axis_name: str = "data") -> RGBDImages:
    r"""This rank's contiguous block of a batch of frames along the mesh
    axis. Batch size must be divisible by the axis size."""
    return frames[_block(mesh, axis_name, len(frames))]


def shard_pointclouds(
    pointclouds: Pointclouds, mesh: DeviceMesh, axis_name: str = "data"
) -> Pointclouds:
    r"""This rank's contiguous block of a batch of map buffers."""
    block = _block(mesh, axis_name, len(pointclouds))
    return dataclasses.replace(pointclouds, **{
        f.name: getattr(pointclouds, f.name)[block]
        for f in dataclasses.fields(pointclouds) if getattr(pointclouds, f.name) is not None})


def _gather_pointclouds(pointclouds: Pointclouds, group) -> Pointclouds:
    """Every rank's block of map buffers concatenated along the batch."""
    return dataclasses.replace(pointclouds, **{
        f.name: collectives.gather_batch(getattr(pointclouds, f.name), group, "batch")
        for f in dataclasses.fields(pointclouds) if getattr(pointclouds, f.name) is not None})


class DataParallelSLAM:
    r"""Wrap an ``ICPSLAM``/``PointFusion`` pipeline for batch-sharded
    execution on a device mesh: every rank passes the whole batch, runs its
    block of it, and gets back the whole batch's results.

    Example::

        torch.distributed.init_process_group("nccl", init_method=..., rank=r, world_size=n)
        slam = DataParallelSLAM(PointFusion(odom="gt"), make_mesh())
        pointclouds, poses = slam(frames)   # batch sharded over all ranks

    The wrapped pipeline runs its block as it would alone, its frames
    replayed from its own CUDA graphs with ``use_jit`` (under autograd too,
    ``step`` included); the gathers of the results run eagerly after it.
    """

    def __init__(self, slam, mesh: Optional[DeviceMesh] = None, axis_name: str = "data"):
        self.slam = slam
        self.mesh = mesh if mesh is not None else make_mesh(axis_name=axis_name)
        self.axis_name = axis_name
        self.group = self.mesh.get_group(axis_name)

    def __call__(self, frames: RGBDImages) -> Tuple[Pointclouds, torch.Tensor]:
        pointclouds, poses = self.slam(shard_frames(frames, self.mesh, self.axis_name))
        return (_gather_pointclouds(pointclouds, self.group),
                collectives.gather_batch(poses, self.group, "batch"))

    def step(self, pointclouds, live_frame, prev_frame=None, prev_transform=None):
        """Single online SLAM step on this rank's block of the batch (same
        contract as ``ICPSLAM.step``, including the optional
        constant-velocity ``prev_transform`` prior, split over the same
        axis); returns the whole batch's map and poses."""
        pointclouds = shard_pointclouds(pointclouds, self.mesh, self.axis_name)
        live_frame = shard_frames(live_frame, self.mesh, self.axis_name)
        if prev_frame is not None:
            prev_frame = shard_frames(prev_frame, self.mesh, self.axis_name)
        if prev_transform is not None:
            prev_transform = prev_transform[_block(self.mesh, self.axis_name,
                                                   prev_transform.shape[0])]
        pointclouds, poses = self.slam.step(pointclouds, live_frame, prev_frame, prev_transform)
        return (_gather_pointclouds(pointclouds, self.group),
                collectives.gather_batch(poses, self.group, "batch"))
