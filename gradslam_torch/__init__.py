r"""gradslam_torch: the PyTorch / CUDA port of gradslam_tpu.

ICPSLAM (aggregate map) and PointFusion SLAM with ground-truth, ICP or
GradICP tracking (1-NN or projective association with sub-pixel lookup and
point rows, pyramids, recency windows, robust kernels, constant velocity,
map pruning, quantized colors, user feature channels, tracking health,
relocalization and the keyframe drift anchor), offline (``forward``) or
one frame at a time (``step``, ``localize``, ``map_update``), with the
K-NN search and ``estimate_normals``, written in PyTorch, with the
nearest-neighbour search and the unique-row scatter as hand-written CUDA
kernels for Hopper (``ops/csrc/knn.cu``, ``ops/csrc/scatter.cu``). From
disk to disk: the TUM, ICL and ScanNet loaders (``datasets``, with the
port's own PNG codec), PLY, TUM-trajectory and checkpoint IO
(``structures.io``, ``utils``), ``config.CfgNode`` and the example CLIs
(``python -m gradslam_torch.examples.<name>``). The JAX package
``gradslam_tpu`` is the reference it is tested against. This package
imports neither JAX nor ``gradslam_tpu``.
"""

from . import config, datasets, metrics, utils
from .datasets import hard_sequence, synthetic_sequence
from .geometry import *  # noqa: F401,F403
from .geometry import __all__ as _geometry_all
from .odometry import (
    GradICPOdometryProvider,
    GroundTruthOdometryProvider,
    ICPOdometryProvider,
    OdometryProvider,
)
from .slam import (
    ICPSLAM,
    PointFusion,
    keyframe_anchor,
    perturbation_grid,
    relocalize,
    tracking_health,
)
from .structures import Pointclouds, RGBDImages, estimate_normals, pointclouds_from_rgbdimages

__all__ = [
    "GradICPOdometryProvider",
    "GroundTruthOdometryProvider",
    "ICPOdometryProvider",
    "ICPSLAM",
    "OdometryProvider",
    "PointFusion",
    "Pointclouds",
    "RGBDImages",
    "estimate_normals",
    "hard_sequence",
    "keyframe_anchor",
    "metrics",
    "perturbation_grid",
    "pointclouds_from_rgbdimages",
    "relocalize",
    "synthetic_sequence",
    "tracking_health",
] + list(_geometry_all)
