"""Nearest-neighbour search of the PyTorch port: the plain PyTorch version
(:func:`nn_points`), the hand-written CUDA kernel (:func:`nn_points_cuda`)
and the dispatcher the odometry calls (:func:`nn_points_auto`)."""

from __future__ import annotations

from . import knn_cuda
from .knn import nn_points
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


__all__ = ["knn_cuda", "nn_points", "nn_points_cuda", "nn_points_auto"]
