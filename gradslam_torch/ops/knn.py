r"""Brute-force nearest-neighbour search, plain PyTorch.

Counterpart of ``gradslam_tpu/ops/knn.py`` (``_apply_tgt_mask`` :42,
``nn_points`` :117, ``_knn_k_single`` :155, ``knn_points`` :225).

:func:`nn_points` is the contract of the hand-written CUDA 1-NN kernel in
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

:func:`knn_points` is the chamferdist-style K-NN: ``K = 1`` through
:func:`gradslam_torch.ops.nn_points_auto` (the kernel on the card), ``K >
1`` as JAX computes it outside any Pallas kernel, a streaming top-K over
target tiles in plain PyTorch on either device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["knn_points", "nn_points"]

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


def _order_keys(d2: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """int64 keys that order ``(d2, idx)`` pairs lexicographically: the
    float32 bits mapped to an order-preserving int32 (negative values
    flipped; -0.0 folded into +0.0) in the high word, the index (below
    2**31) in the low word. Every key is unique per index, so a top-K of
    the keys has one answer: the smallest distances, ties to the smallest
    index."""
    bits = (d2 + 0.0).view(torch.int32)
    ordered = bits ^ ((bits >> 31) & 0x7FFFFFFF)
    return (ordered.to(torch.int64) << 32) | idx


def _split_keys(keys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``(d2, idx)`` pairs of :func:`_order_keys`, bit for bit."""
    ordered = (keys >> 32).to(torch.int32)
    bits = ordered ^ ((ordered >> 31) & 0x7FFFFFFF)
    return bits.view(torch.float32), (keys & 0xFFFFFFFF).to(torch.int32)


_ROW_CHUNK = 65_536  # sources a pass over the targets in knn_points' K > 1


def _knn_k(src, tgt, penalty, K: int, tile_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K nearest targets ``(B, N, K)`` (ascending; ties to the smallest
    index), JAX's ``_knn_k_single``: the targets stream in tiles, each
    merged with the running K best. JAX merges with a stable ``lax.top_k``
    over the carry followed by the tile; here the merge is a ``topk`` of
    :func:`_order_keys`, whose unique keys give the same order on any
    device (``torch.topk`` itself promises no order among ties). The
    sources go in chunks of ``_ROW_CHUNK`` rows, which bounds the memory:
    a tile's candidate block is ``_ROW_CHUNK * (K + tile_size)`` int64 keys
    (546 MB at K = 17 and the default tile), with a few temporaries of
    ``_ROW_CHUNK * tile_size`` elements."""
    t2 = _sq_norm_fma(tgt)
    d, i = [], []
    for rows in src.split(_ROW_CHUNK, dim=1):
        B, N, _ = rows.shape
        s2 = _sq_norm_fma(rows)[:, :, None]
        # JAX's init carry (+1e30, index 0)
        best = _order_keys(torch.full((B, N, K), _INF, dtype=src.dtype, device=src.device),
                           torch.zeros((B, N, K), dtype=torch.int64, device=src.device))
        for start in range(0, tgt.shape[1], tile_size):
            stop = min(start + tile_size, tgt.shape[1])
            cross = torch.bmm(rows, tgt[:, start:stop].transpose(1, 2))
            d2 = s2 + t2[:, None, start:stop] - 2.0 * cross + penalty[:, None, start:stop]
            idx = torch.arange(start, stop, device=src.device).expand_as(d2)
            cand = torch.cat([best, _order_keys(d2, idx)], dim=2)
            best = torch.topk(cand, K, dim=2, largest=False, sorted=True).values
        d_rows, i_rows = _split_keys(best)
        d.append(d_rows)
        i.append(i_rows)
    return torch.clamp(torch.cat(d, dim=1), min=0.0), torch.cat(i, dim=1)


class _KNNResult:
    """chamferdist / pytorch3d-style result: ``.dists``, ``.idx`` ``(B, N,
    K)`` and ``.knn`` ``(B, N, K, 3)`` (or None); iterable and indexable
    like their namedtuple."""

    __slots__ = ("dists", "idx", "knn")

    def __init__(self, dists, idx, knn=None):
        self.dists = dists
        self.idx = idx
        self.knn = knn

    def __iter__(self):
        return iter((self.dists, self.idx, self.knn))

    def __getitem__(self, i):
        return (self.dists, self.idx, self.knn)[i]


def knn_points(
    src: torch.Tensor,
    tgt: torch.Tensor,
    lengths1: Optional[torch.Tensor] = None,
    lengths2: Optional[torch.Tensor] = None,
    K: int = 1,
    return_nn: bool = False,
    *,
    tgt_mask: Optional[torch.Tensor] = None,
    tile_size: int = 1024,
) -> _KNNResult:
    r"""chamferdist-compatible K-NN: ``.dists`` / ``.idx`` ``(B, N, K)``
    (squared distances, ascending, ties to the smallest target index; int32
    indices) and, with ``return_nn``, ``.knn`` the neighbours ``(B, N, K,
    3)``. The positional order is chamferdist's and pytorch3d's,
    ``knn_points(p1, p2, lengths1, lengths2, K, return_nn)``; ``tgt_mask``
    and ``tile_size`` are keyword-only. ``(N, 3)`` inputs give unbatched
    results.

    ``lengths1`` / ``lengths2``: valid counts a batch row; rows past
    ``lengths1`` are zeroed in the outputs, targets past ``lengths2`` never
    neighbours. ``tgt_mask`` is the per-point form of ``lengths2``. Masked
    targets are zeroed before the search, so NaN padding is harmless, and
    ``.knn`` gathers from the zeroed targets. Slots with no valid
    neighbour (fewer than ``K`` valid targets) hold distance 0 and index 0.

    ``K = 1`` goes through :func:`gradslam_torch.ops.nn_points_auto`, on
    the card the hand 1-NN kernel; ``K > 1`` through the tiled top-K. The
    distances and indices are association values with no gradient;
    ``.knn`` is differentiable in ``tgt``.
    """
    from . import nn_points_auto  # the package's dispatcher; imports this module

    if K < 1:
        raise ValueError(f"K must be >= 1. Got {K}.")
    if K > tgt.shape[-2]:
        raise ValueError(
            f"K ({K}) cannot exceed the number of target points ({tgt.shape[-2]})."
        )
    _check_shapes(src, tgt)
    squeeze = src.ndim == 2
    if squeeze:
        src, tgt = src[None], tgt[None]
        tgt_mask = None if tgt_mask is None else tgt_mask[None]
        lengths1 = None if lengths1 is None else torch.as_tensor(lengths1).reshape(1)
        lengths2 = None if lengths2 is None else torch.as_tensor(lengths2).reshape(1)
    B, M = tgt.shape[0], tgt.shape[1]
    if lengths2 is not None:
        in_range = (torch.arange(M, device=tgt.device)[None, :]
                    < torch.as_tensor(lengths2, device=tgt.device)[:, None])
        tgt_mask = in_range if tgt_mask is None else tgt_mask & in_range
    # zeroed once, before the K dispatch: both searches and the gather of
    # the neighbours read the zeroed targets
    tgt, penalty = _apply_tgt_mask(tgt, tgt_mask)
    if K == 1:
        d, i = nn_points_auto(src, tgt, tgt_mask)
        d, i = d[..., None], i[..., None]
    else:
        d, i = _knn_k(src.detach(), tgt.detach(), penalty, K, tile_size)
    if tgt_mask is not None:
        empty = d >= _INF * 0.5  # the sentinel; no real distance comes near it
        d = torch.where(empty, torch.zeros_like(d), d)
        i = torch.where(empty, torch.zeros_like(i), i)
    if lengths1 is not None:
        row_ok = (torch.arange(src.shape[1], device=src.device)[None, :]
                  < torch.as_tensor(lengths1, device=src.device)[:, None])[..., None]
        d = torch.where(row_ok, d, torch.zeros_like(d))
        i = torch.where(row_ok, i, torch.zeros_like(i))
    nn = None
    if return_nn:
        nn = torch.gather(tgt, 1, i.long().reshape(B, -1, 1).expand(-1, -1, 3)).reshape(
            i.shape + (3,))
    if squeeze:
        d, i = d[0], i[0]
        nn = None if nn is None else nn[0]
    return _KNNResult(d, i, nn)
