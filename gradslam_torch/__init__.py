r"""gradslam_torch: the PyTorch / CUDA port of gradslam_tpu.

ICPSLAM (aggregate map) and PointFusion SLAM with ground-truth, ICP or
GradICP tracking (1-NN or projective association, pyramids, recency
windows, robust kernels, constant velocity, map pruning, quantized colors),
written in PyTorch, with the nearest-neighbour search and the unique-row
scatter as hand-written CUDA kernels for Hopper (``ops/csrc/knn.cu``,
``ops/csrc/scatter.cu``). The JAX package ``gradslam_tpu`` is the reference
it is tested against. This package imports neither JAX nor
``gradslam_tpu``.
"""

from .datasets import hard_sequence, synthetic_sequence
from .slam import ICPSLAM, PointFusion
from .structures import Pointclouds, RGBDImages

__all__ = [
    "ICPSLAM",
    "PointFusion",
    "Pointclouds",
    "RGBDImages",
    "hard_sequence",
    "synthetic_sequence",
]
