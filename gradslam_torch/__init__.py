r"""gradslam_torch: the PyTorch / CUDA port of gradslam_tpu.

PointFusion SLAM with ground-truth or GradICP tracking (1-NN or projective
association, pyramids, robust kernels, constant velocity, map pruning,
quantized colors), written in PyTorch, with the nearest-neighbour search as a
hand-written CUDA kernel for Hopper (``ops/csrc/knn.cu``). The JAX package ``gradslam_tpu`` is the reference it
is tested against. This package imports neither JAX nor ``gradslam_tpu``.
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
