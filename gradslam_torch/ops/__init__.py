"""Kernels of the PyTorch port and their plain versions.

- Nearest-neighbour search: the plain PyTorch version (:func:`nn_points`),
  the hand-written CUDA kernel (:func:`nn_points_cuda`), the dispatcher
  the odometry calls (:func:`nn_points_auto`), and the chamferdist-style
  K-NN (:func:`knn_points`: its K = 1 goes through the dispatcher).
- Unique-row scatter: the plain versions (``scatter.py``) and the
  hand-written CUDA kernel (``scatter_cuda.py``); the dispatchers are
  :func:`gradslam_torch.structures.pointclouds.scatter_rows` and
  ``scatter_rows_into``.
"""

from __future__ import annotations

from . import knn_cuda, scatter_cuda
from .knn import knn_points, nn_points
from .knn_cuda import nn_points_cuda


def nn_points_auto(src, tgt, tgt_mask=None):
    """1-NN dispatched by the tensors' device: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors. No fallback: on the card
    the kernel runs or the call raises.

    The results are non-differentiable association plumbing, as in the JAX
    package: the inputs are detached.
    """
    src = src.detach().contiguous()
    tgt = tgt.detach().contiguous()
    if tgt_mask is not None:
        tgt_mask = tgt_mask.detach().contiguous()
    if src.is_cuda:
        return nn_points_cuda(src, tgt, tgt_mask)
    return nn_points(src, tgt, tgt_mask)


__all__ = [
    "knn_cuda", "scatter_cuda", "knn_points", "nn_points", "nn_points_cuda", "nn_points_auto",
]
