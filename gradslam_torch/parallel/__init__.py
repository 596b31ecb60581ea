r"""Multi-process SLAM on ``torch.distributed``: data parallelism over the
batch (:class:`DataParallelSLAM`) and the map sharded over its point axis
(:class:`MapShardedPointFusion`). Counterpart of ``gradslam_tpu/parallel``;
every rank calls the same entry point with the same arguments, after the
caller has initialised the default process group (NCCL on the card, gloo on
the CPU)."""

from .map_sharded import (
    MapShardedPointFusion,
    ShardedMap,
    nn_points_map_sharded,
)
from .sharding import (
    DataParallelSLAM,
    batch_sharding,
    make_mesh,
    map_sharded_spec,
    shard_frames,
    shard_pointclouds,
)

__all__ = [
    "DataParallelSLAM",
    "MapShardedPointFusion",
    "ShardedMap",
    "nn_points_map_sharded",
    "make_mesh",
    "batch_sharding",
    "map_sharded_spec",
    "shard_frames",
    "shard_pointclouds",
]
