r"""Wrapper of the hand-written CUDA 1-NN kernel (``csrc/knn.cu``).

Same contract as :func:`gradslam_torch.ops.knn.nn_points`, its plain
version. The wrapper validates its inputs, picks how many splits the targets
are cut into (:func:`split_plan`), allocates the outputs and the scratch
with ``torch.empty``, makes one call into the C entry point, which launches
the kernels on PyTorch's current stream, and raises if a launch is refused.
It takes CUDA tensors only: a CPU tensor raises here (the dispatcher
:func:`gradslam_torch.ops.nn_points_auto` sends those to the plain version).
There is no gradient, as the TPU kernel had none.

``launches`` counts wrapper calls that launch the search: it grows by one
for each such call and nowhere else, whatever number of device kernels the
call launches (the target prologue, the search and the merge).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from .knn import _check_shapes

__all__ = ["nn_points_cuda", "split_plan", "split_plan_for", "launches"]

launches = 0

CHUNK = 32  # targets between two checks of the running min (knn.cu kChunk)
ROWS = 512  # sources a search block (knn.cu kThreads * kR)
# The split plan's cost model: the search blocks an SM needs before its
# float32 issue is busy, and a block's fixed cost (loading its sources,
# filling the first tile, writing its partials) in chunks of search work.
# With these, the plan's split count comes within a few percent of the best
# of a sweep at the paths' three shapes (chip_smoke.py phase 3, PERF.md).
SATURATING_BLOCKS = 3
BLOCK_OVERHEAD_CHUNKS = 2

_device_limits = {}  # device index -> (SMs, resident search blocks an SM)


@functools.lru_cache(maxsize=1024)
def split_plan(
    B: int, N: int, M: int, sms: int, resident: int, splits: Optional[int] = None
) -> Tuple[int, int]:
    r"""``(S, per)``: the targets are cut into ``S`` contiguous splits of
    ``per`` rows (a whole number of chunks); split ``s`` covers rows
    ``[s * per, min((s + 1) * per, M))``, so every target lies in exactly
    one split, and ``S >= 1`` even for ``M = 0``.

    Without ``splits``, ``S`` minimises the estimated time of the search,
    ``max(q, SATURATING_BLOCKS) * (per / CHUNK + BLOCK_OVERHEAD_CHUNKS)``,
    where ``q`` is the most blocks an SM runs (the grid is ``ceil(N / ROWS)
    * S * B`` blocks over ``sms`` SMs), among the plans whose grid the card
    holds in one wave (``q <= resident``) or ``S = 1``. ``splits`` forces
    ``S`` (the chip checks use it; splits past the end of the targets are
    empty)."""
    chunks = max(1, -(-M // CHUNK))
    if splits is not None:
        if splits < 1:
            raise ValueError(f"splits must be >= 1. Got {splits}.")
        return splits, -(-chunks // splits) * CHUNK
    blocks = B * max(1, -(-N // ROWS))
    best = None
    for s in range(1, chunks + 1):
        per = -(-chunks // s)
        s = -(-chunks // per)  # no empty split
        q = -(-blocks * s // sms)
        if s > 1 and q > resident:
            break
        cost = max(q, SATURATING_BLOCKS) * (per + BLOCK_OVERHEAD_CHUNKS)
        if best is None or cost < best[0]:
            best = (cost, s, per)
    return best[1], best[2] * CHUNK


def split_plan_for(
    B: int, N: int, M: int, device: torch.device, splits: Optional[int] = None
) -> Tuple[int, int]:
    """:func:`split_plan` on ``device``'s SM count and the search blocks one
    of its SMs holds (read once a device; builds the kernels if needed)."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _device_limits:
        from ._build import load_library

        with torch.cuda.device(index):
            resident = load_library().gradslam_knn1_resident_blocks()
        if resident < 1:
            raise RuntimeError("gradslam_knn1_resident_blocks failed: no search block fits an SM.")
        sms = torch.cuda.get_device_properties(index).multi_processor_count
        _device_limits[index] = (sms, resident)
    return split_plan(B, N, M, *_device_limits[index], splits)


def nn_points_cuda(
    src: torch.Tensor,
    tgt: torch.Tensor,
    tgt_mask: Optional[torch.Tensor] = None,
    *,
    splits: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    r"""1-NN on the card. ``src (N, 3)``/``(B, N, 3)``, ``tgt (M, 3)``/
    ``(B, M, 3)`` float32 contiguous CUDA tensors on one device, optional
    ``tgt_mask (M,)``/``(B, M)`` bool. Returns float32 squared distances and
    int32 indices ``(.., N)``.

    ``splits`` forces the number of target splits (default:
    :func:`split_plan`); the result is the same bit for bit. It exists for
    the chip checks and timings."""
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
            S, per = split_plan_for(B, N, M, src.device, splits)
            m_pad = -(-M // CHUNK) * CHUNK
            nbytes = 16 * B * m_pad + 8 * B * S * N
            scratch = torch.empty(nbytes, dtype=torch.uint8, device=src.device)
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.gradslam_knn1(
                src.data_ptr(), tgt.data_ptr(),
                None if tgt_mask is None else tgt_mask.data_ptr(),
                dists.data_ptr(), idx.data_ptr(), B, N, M, S, per,
                scratch.data_ptr(), stream,
            )
        if err != 0:
            raise RuntimeError(f"gradslam_knn1 launch failed: cudaError {err}.")
        launches += 1
    if not batched:
        return dists[0], idx[0]
    return dists, idx
