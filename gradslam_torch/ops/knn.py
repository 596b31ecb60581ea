r"""Brute-force 1-nearest-neighbour search, plain PyTorch.

Counterpart of ``gradslam_tpu/ops/knn.py`` (``_apply_tgt_mask`` :42,
``nn_points`` :117) and the contract of the hand-written CUDA kernel in
:mod:`.knn_cuda`: for every source point, the squared distance and int32
index of the nearest valid target, computed in the expanded form
``d2 = |s|^2 + (|t|^2 + penalty) - 2 s.t`` with

- masked targets zeroed (NaN padding cannot poison a tile) and given a
  +1e30 penalty, so they never win;
- ties going to the smallest index (strict ``<`` across target tiles,
  first minimum inside a tile);
- distances clamped to >= 0;
- ``|s|^2`` and ``|t|^2`` rounded as the FMA chain ``fma(z, z, fma(y, y,
  x * x))``, as the kernel and XLA's CPU backend compute them.

Targets stream through in tiles, so the N x M distance matrix never exists
whole. The cross term is a float32 ``bmm``; the pipelines turn TF32 off
(:mod:`gradslam_torch.utils.precision`), so on the card it is full float32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["nn_points"]

_INF = 1e30


def _apply_tgt_mask(
    tgt: torch.Tensor, tgt_mask: Optional[torch.Tensor]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(tgt_zeroed, penalty)``: masked rows zeroed, +1e30 penalty on them."""
    if tgt_mask is None:
        return tgt, torch.zeros(tgt.shape[:-1], dtype=tgt.dtype, device=tgt.device)
    penalty = torch.where(
        tgt_mask,
        torch.zeros((), dtype=tgt.dtype, device=tgt.device),
        torch.full((), _INF, dtype=tgt.dtype, device=tgt.device),
    )
    return torch.where(tgt_mask[..., None], tgt, torch.zeros_like(tgt)), penalty


def _check_shapes(src: torch.Tensor, tgt: torch.Tensor) -> None:
    if src.shape[-1] != 3 or tgt.shape[-1] != 3:
        raise ValueError(
            f"src/tgt must have trailing dim 3. Got {tuple(src.shape)} and {tuple(tgt.shape)}."
        )
    if src.ndim != tgt.ndim or src.ndim not in (2, 3):
        raise ValueError(
            "src and tgt must both be (N, 3) or (B, N, 3). "
            f"Got {tuple(src.shape)} and {tuple(tgt.shape)}."
        )


def _sq_norm_fma(x: torch.Tensor) -> torch.Tensor:
    """``|x|^2`` of ``(..., 3)`` float32 rows rounded as the FMA chain
    ``fma(z, z, fma(y, y, x * x))`` that the CUDA kernel and XLA's CPU
    backend compute: each step is exact in float64 and rounded once to
    float32. A plain ``sum(x * x)`` rounds every product and differs by an
    ulp, which flips near-tie indices."""
    if x.dtype != torch.float32:
        return torch.sum(x * x, dim=-1)
    acc = x[..., 0] * x[..., 0]
    for k in (1, 2):
        xk = x[..., k].double()
        acc = (xk * xk + acc.double()).float()
    return acc


def nn_points(
    src: torch.Tensor,
    tgt: torch.Tensor,
    tgt_mask: Optional[torch.Tensor] = None,
    tile_size: int = 1024,
) -> Tuple[torch.Tensor, torch.Tensor]:
    r"""1-nearest-neighbour from each ``src`` point to the ``tgt`` set.

    Args:
        src: ``(N, 3)`` or batched ``(B, N, 3)`` source points.
        tgt: ``(M, 3)`` or batched ``(B, M, 3)`` target points.
        tgt_mask: optional ``(M,)`` / ``(B, M)`` bool validity mask.
        tile_size: targets per streamed tile.

    Returns:
        ``(dists, idx)``: squared distances and int32 target indices, both
        ``(.., N)``.
    """
    _check_shapes(src, tgt)
    batched = src.ndim == 3
    if not batched:
        src, tgt = src[None], tgt[None]
        tgt_mask = None if tgt_mask is None else tgt_mask[None]
    tgt, penalty = _apply_tgt_mask(tgt, tgt_mask)
    B, N, _ = src.shape
    M = tgt.shape[1]
    s2 = _sq_norm_fma(src)
    t2pen = _sq_norm_fma(tgt) + penalty
    best_d = torch.full((B, N), _INF, dtype=src.dtype, device=src.device)
    best_i = torch.zeros((B, N), dtype=torch.int64, device=src.device)
    for start in range(0, M, tile_size):
        tile = tgt[:, start:start + tile_size]
        cross = torch.bmm(src, tile.transpose(1, 2))
        d2 = s2[:, :, None] + t2pen[:, None, start:start + tile_size] - 2.0 * cross
        tile_best, tile_arg = torch.min(d2, dim=2)
        take = tile_best < best_d
        best_d = torch.where(take, tile_best, best_d)
        best_i = torch.where(take, tile_arg + start, best_i)
    dists = torch.clamp(best_d, min=0.0)
    idx = best_i.to(torch.int32)
    if not batched:
        return dists[0], idx[0]
    return dists, idx
