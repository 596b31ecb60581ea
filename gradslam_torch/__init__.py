r"""gradslam_torch: the PyTorch / CUDA port of gradslam_tpu.

PointFusion SLAM with ground-truth or GradICP tracking, written in PyTorch,
with the nearest-neighbour search as a hand-written CUDA kernel for Hopper
(``ops/csrc/knn.cu``). The JAX package ``gradslam_tpu`` is the reference it
is tested against. This package imports neither JAX nor ``gradslam_tpu``.
"""

from .datasets import synthetic_sequence
from .slam import ICPSLAM, PointFusion
from .structures import Pointclouds, RGBDImages

__all__ = [
    "ICPSLAM",
    "PointFusion",
    "Pointclouds",
    "RGBDImages",
    "synthetic_sequence",
]
