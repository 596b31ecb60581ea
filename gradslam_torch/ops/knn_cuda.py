r"""Wrapper of the hand-written CUDA 1-NN kernel (``csrc/knn.cu``).

Same contract as :func:`gradslam_torch.ops.knn.nn_points`, its plain
version. The wrapper validates its inputs, allocates the outputs with
``torch.empty``, launches on PyTorch's current stream and raises if the
launch is refused. It takes CUDA tensors only: a CPU tensor raises here (the
dispatcher :func:`gradslam_torch.ops.nn_points_auto` sends those to the
plain version). There is no gradient, as the TPU kernel had none.

``launches`` counts kernel launches; it grows by one where the kernel is
launched and nowhere else.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .knn import _check_shapes

__all__ = ["nn_points_cuda", "launches"]

launches = 0


def nn_points_cuda(
    src: torch.Tensor, tgt: torch.Tensor, tgt_mask: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    r"""1-NN on the card. ``src (N, 3)``/``(B, N, 3)``, ``tgt (M, 3)``/
    ``(B, M, 3)`` float32 contiguous CUDA tensors on one device, optional
    ``tgt_mask (M,)``/``(B, M)`` bool. Returns float32 squared distances and
    int32 indices ``(.., N)``."""
    global launches
    tensors = [("src", src), ("tgt", tgt)]
    if tgt_mask is not None:
        tensors.append(("tgt_mask", tgt_mask))
    for name, t in tensors:
        if not t.is_cuda:
            raise ValueError(f"nn_points_cuda takes CUDA tensors; {name} is on {t.device}.")
        if t.device != src.device:
            raise ValueError(f"{name} is on {t.device} but src is on {src.device}.")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous.")
    if src.dtype != torch.float32 or tgt.dtype != torch.float32:
        raise ValueError(f"src/tgt must be float32. Got {src.dtype} and {tgt.dtype}.")
    _check_shapes(src, tgt)
    batched = src.ndim == 3
    if not batched:
        src, tgt = src[None], tgt[None]
        tgt_mask = None if tgt_mask is None else tgt_mask[None]
    B, N, _ = src.shape
    M = tgt.shape[1]
    if tgt.shape[0] != B:
        raise ValueError(f"Batch sizes differ: src {B}, tgt {tgt.shape[0]}.")
    if tgt_mask is not None and (tgt_mask.dtype != torch.bool or tgt_mask.shape != (B, M)):
        raise ValueError(
            f"tgt_mask must be a bool tensor of shape {(B, M)}. "
            f"Got {tgt_mask.dtype} {tuple(tgt_mask.shape)}."
        )
    if max(B * N, B * M) * 3 >= 2**31:
        raise ValueError(f"Point sets too large for int32 indexing: B={B}, N={N}, M={M}.")

    from ._build import load_library

    lib = load_library()
    dists = torch.empty((B, N), dtype=torch.float32, device=src.device)
    idx = torch.empty((B, N), dtype=torch.int32, device=src.device)
    if N > 0:
        with torch.cuda.device(src.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.gradslam_knn1(
                src.data_ptr(), tgt.data_ptr(),
                None if tgt_mask is None else tgt_mask.data_ptr(),
                dists.data_ptr(), idx.data_ptr(), B, N, M, stream,
            )
        if err != 0:
            raise RuntimeError(f"gradslam_knn1 launch failed: cudaError {err}.")
        launches += 1
    if not batched:
        return dists[0], idx[0]
    return dists, idx
