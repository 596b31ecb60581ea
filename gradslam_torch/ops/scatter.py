r"""Unique-row scatter, plain PyTorch version.

Contract of the hand-written CUDA kernel (``csrc/scatter.cu``, wrapper
``scatter_cuda.py``):

- ``scatter_rows_plain(size, dest, values, fill)``: a new ``(B, size, *C)``
  table filled with ``fill``, then ``out[b, dest[b, m]] = values[b, m]``;
- ``scatter_rows_into_plain(buf, dest, values)``: a copy of ``buf (B, S,
  *C)`` with the same row writes.

``dest (B, M)`` is an integer tensor whose entries inside ``[0, size)`` are
unique in each batch row; every other entry (past the end, or negative) is
dropped. This is JAX's ``.at[...].set(mode="drop", unique_indices=True)``.
Here the dropped rows go to unique trash rows past the end of a larger
buffer, which is cut off afterwards: no index is out of bounds, and every
row is written at most once, so the result is deterministic.
"""

from __future__ import annotations

import torch

__all__ = ["scatter_rows_plain", "scatter_rows_into_plain"]


def _write(padded: torch.Tensor, size: int, dest: torch.Tensor, values: torch.Tensor):
    B, M = dest.shape
    ar = torch.arange(M, device=dest.device)[None, :]
    keep = (dest >= 0) & (dest < size)
    slot = torch.where(keep, dest.long(), size + ar)
    bidx = torch.arange(B, device=dest.device)[:, None].expand(B, M)
    out = padded.index_put((bidx, slot), values.to(padded.dtype), accumulate=False)
    return out[:, :size].contiguous()


def scatter_rows_plain(size: int, dest: torch.Tensor, values: torch.Tensor, fill=0):
    r"""``values (B, M, *C)`` written to rows ``dest (B, M)`` of a new
    ``(B, size, *C)`` table filled with ``fill``."""
    B, M = dest.shape
    padded = torch.full(
        (B, size + M) + tuple(values.shape[2:]), fill, dtype=values.dtype, device=values.device
    )
    return _write(padded, size, dest, values)


def scatter_rows_into_plain(buf: torch.Tensor, dest: torch.Tensor, values: torch.Tensor):
    r"""A copy of ``buf (B, S, *C)`` with ``values (B, M, *C)`` written to
    rows ``dest (B, M)``."""
    B, M = dest.shape
    pad = buf.new_zeros((B, M) + tuple(buf.shape[2:]))
    return _write(torch.cat([buf, pad], dim=1), buf.shape[1], dest, values)
