r"""Float32 precision policy for the PyTorch port.

Counterpart of ``gradslam_tpu/utils/precision.py`` (``matmul_hp`` /
``einsum_hp``): on the TPU every small-matrix contraction asked for
``Precision.HIGHEST`` because default bf16 passes lose ~3 decimal digits,
which SE(3) pose chains and the expanded-form nearest-neighbour distances
cannot afford. On Hopper the same trap is TF32: a float32 matmul or
convolution that is allowed to use TF32 tensor cores keeps a 10-bit mantissa.
The pipelines call :func:`disable_tf32` when they are built, so every
float32 ``matmul``/``einsum`` in the port runs in full float32. The geometry
helpers and the ``Pointclouds`` operations a user may call outside a
pipeline run under :func:`fp32_products`, which turns TF32 off for the call
and restores the caller's flags after it.
"""

from __future__ import annotations

import contextlib

import torch

__all__ = ["disable_tf32", "fp32_products", "tf32_disabled"]


def disable_tf32() -> None:
    """Turn TF32 off for float32 matmuls (cuBLAS) and convolutions (cuDNN)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def tf32_disabled() -> bool:
    """True when neither cuBLAS nor cuDNN may use TF32 for float32 work."""
    return not (
        torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32
    )


@contextlib.contextmanager
def fp32_products():
    """TF32 off inside the block (or the decorated function), the caller's
    two flags restored on the way out."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    disable_tf32()
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
