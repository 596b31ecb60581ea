r"""Batched pointclouds as fixed-capacity padded buffers (PyTorch).

Counterpart of ``gradslam_tpu/structures/pointclouds.py``: a frozen
dataclass of tensors

- ``points`` ``(B, CAP, 3)`` padded point buffer,
- ``num_points`` ``(B,)`` int64 live-point counters,
- optional ``normals``/``colors`` ``(B, CAP, 3)`` and ``features``
  ``(B, CAP, C)``,
- optional ``num_dropped`` ``(B,)`` int64: rows lost to a full buffer.

Writes that JAX parks past the end of an array and drops with
``mode="drop"`` go through :func:`scatter_rows` and :func:`scatter_rows_into`,
which drop every destination outside the table: on the card in the
hand-written scatter kernel (``ops/csrc/scatter.cu``), on the CPU in the
plain version (``ops/scatter.py``). Every destination inside the table is
unique, so the writes are deterministic.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from ..ops import scatter_cuda
from ..ops.scatter import scatter_rows_into_plain, scatter_rows_plain
from .io import save_ply as _save_ply

__all__ = ["Pointclouds", "compact_masked", "gather_rows", "scatter_rows", "scatter_rows_into"]


def _scatter_rows(size, dest, values, fill):
    if values.is_cuda:
        return scatter_cuda.scatter_rows_cuda(size, dest.contiguous(), values.contiguous(), fill)
    return scatter_rows_plain(size, dest, values, fill)


def _scatter_rows_into(buf, dest, values):
    if values.is_cuda:
        return scatter_cuda.scatter_rows_into_cuda(
            buf.contiguous(), dest.contiguous(), values.contiguous())
    return scatter_rows_into_plain(buf, dest, values)


def _rows_at(grad: torch.Tensor, dest: torch.Tensor) -> torch.Tensor:
    """Rows of ``grad (B, S, *C)`` at ``dest (B, M)``, zero where ``dest``
    lies outside ``[0, S)``: the gradient of the scattered values."""
    B, M = dest.shape
    S = grad.shape[1]
    keep = (dest >= 0) & (dest < S)
    rows = gather_rows(grad.reshape(B, S, -1), torch.where(keep, dest, torch.zeros_like(dest)))
    rows = torch.where(keep[..., None], rows, torch.zeros_like(rows))
    return rows.reshape((B, M) + tuple(grad.shape[2:]))


class _ScatterRows(torch.autograd.Function):
    """``scatter_rows`` with the gradient of the values: the output's
    gradient rows at ``dest``, zero for dropped rows."""

    @staticmethod
    def forward(ctx, size, dest, values, fill):
        ctx.save_for_backward(dest)
        return _scatter_rows(size, dest, values, fill)

    @staticmethod
    def backward(ctx, grad):
        (dest,) = ctx.saved_tensors
        return None, None, _rows_at(grad, dest), None


class _ScatterRowsInto(torch.autograd.Function):
    """``scatter_rows_into`` with the gradients of the buffer (the output's
    gradient with the overwritten rows zeroed, by the same scatter) and of
    the values."""

    @staticmethod
    def forward(ctx, buf, dest, values):
        ctx.save_for_backward(dest)
        ctx.values_shape = values.shape
        return _scatter_rows_into(buf, dest, values)

    @staticmethod
    def backward(ctx, grad):
        (dest,) = ctx.saved_tensors
        g_buf = g_val = None
        if ctx.needs_input_grad[0]:
            g_buf = scatter_rows_into(grad, dest, grad.new_zeros(ctx.values_shape))
        if ctx.needs_input_grad[2]:
            g_val = _rows_at(grad, dest)
        return g_buf, None, g_val


def scatter_rows(
    size: int, dest: torch.Tensor, values: torch.Tensor, fill=0
) -> torch.Tensor:
    r"""Write ``values (B, M, *C)`` to rows ``dest (B, M)`` of a new
    ``(B, size, *C)`` table filled with ``fill``.

    Destinations outside ``[0, size)`` are dropped; those inside must be
    unique in each batch row. A CUDA tensor launches the scatter kernel, a
    CPU tensor takes the plain version; nothing falls back. Float values
    that need a gradient get it (the output's gradient rows at ``dest``).
    """
    if torch.is_grad_enabled() and values.requires_grad:
        return _ScatterRows.apply(size, dest, values, fill)
    return _scatter_rows(size, dest, values, fill)


def scatter_rows_into(buf: torch.Tensor, dest: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    r"""A copy of ``buf (B, S, *C)`` with ``values (B, M, *C)`` (cast to
    ``buf``'s dtype) written to rows ``dest (B, M)``: JAX's
    ``buf.at[b, dest].set(values, mode="drop", unique_indices=True)``.
    ``buf`` itself is not written. Dispatch and gradients as
    :func:`scatter_rows`.
    """
    values = values.to(buf.dtype)
    if torch.is_grad_enabled() and (values.requires_grad or buf.requires_grad):
        return _ScatterRowsInto.apply(buf, dest, values)
    return _scatter_rows_into(buf, dest, values)


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of ``x (B, M, C)`` at ``idx (B, N)`` (any integer dtype):
    ``(B, N, C)``."""
    return torch.gather(x, 1, idx.long()[..., None].expand(-1, -1, x.shape[-1]))


def compact_masked(values: torch.Tensor, mask: torch.Tensor, capacity: int):
    r"""Compact the masked rows of ``values (B, M, C)`` to the front of a
    ``(B, capacity, C)`` buffer, in order. Returns ``(buffer, counts)``;
    rows past ``capacity`` are dropped."""
    rank = torch.cumsum(mask.to(torch.int64), dim=-1) - 1
    dest = torch.where(mask, rank, torch.full_like(rank, -1))  # rank >= capacity drops too
    out = scatter_rows(capacity, dest, values)
    counts = torch.clamp(mask.sum(dim=-1), max=capacity)
    return out, counts


@dataclass(frozen=True)
class Pointclouds:
    r"""A batch of ``B`` pointclouds in fixed-capacity padded buffers."""

    points: torch.Tensor  # (B, CAP, 3)
    num_points: torch.Tensor  # (B,) int64
    normals: Optional[torch.Tensor] = None  # (B, CAP, 3)
    colors: Optional[torch.Tensor] = None  # (B, CAP, 3)
    features: Optional[torch.Tensor] = None  # (B, CAP, C)
    num_dropped: Optional[torch.Tensor] = None  # (B,) int64

    def __post_init__(self):
        pts = self.points
        if pts.ndim != 3 or pts.shape[-1] != 3:
            raise ValueError(f"points must have shape (B, CAP, 3). Got {tuple(pts.shape)}.")
        for name in ("normals", "colors", "features"):
            attr = getattr(self, name)
            if attr is not None and attr.shape[:2] != pts.shape[:2]:
                raise ValueError(
                    f"{name} must have shape (B, CAP, *). Got {tuple(attr.shape)} "
                    f"for points of shape {tuple(pts.shape)}."
                )

    @classmethod
    def empty(
        cls,
        batch_size: int,
        capacity: int,
        *,
        device="cuda",
        dtype=torch.float32,
        has_normals: bool = True,
        has_colors: bool = True,
        feature_dim: Optional[int] = 1,
    ) -> "Pointclouds":
        """An empty map buffer that tracks ``num_dropped``, on ``device``
        (the card by default)."""

        def zeros(c):
            return torch.zeros((batch_size, capacity, c), device=device, dtype=dtype)

        counter = torch.zeros((batch_size,), device=device, dtype=torch.int64)
        return cls(
            points=zeros(3),
            num_points=counter,
            normals=zeros(3) if has_normals else None,
            colors=zeros(3) if has_colors else None,
            features=zeros(feature_dim) if feature_dim else None,
            num_dropped=counter.clone(),
        )

    def __len__(self) -> int:
        return self.points.shape[0]

    @property
    def capacity(self) -> int:
        return self.points.shape[1]

    @property
    def device(self) -> torch.device:
        return self.points.device

    @property
    def nonpad_mask(self) -> torch.Tensor:
        """``(B, CAP)`` bool, True for live points."""
        idx = torch.arange(self.capacity, device=self.device)[None, :]
        return idx < self.num_points[:, None]

    def _list(self, buf: Optional[torch.Tensor]) -> Optional[List[np.ndarray]]:
        if buf is None:
            return None
        arr = buf.detach().cpu().numpy()
        counts = self.num_points.cpu().numpy()
        return [arr[b, : counts[b]] for b in range(len(self))]

    @property
    def points_list(self) -> List[np.ndarray]:
        """Host-side ragged view of the live points."""
        return self._list(self.points)

    @property
    def normals_list(self) -> Optional[List[np.ndarray]]:
        return self._list(self.normals)

    @property
    def colors_list(self) -> Optional[List[np.ndarray]]:
        return self._list(self.colors)

    @property
    def features_list(self) -> Optional[List[np.ndarray]]:
        return self._list(self.features)

    def with_capacity(self, capacity: int) -> "Pointclouds":
        """Copy whose buffers are zero-padded to ``capacity`` (grow only);
        contents and counters unchanged."""
        if capacity == self.capacity:
            return self
        if capacity < self.capacity:
            raise ValueError(
                f"with_capacity can only grow the buffer: requested {capacity} "
                f"< current capacity {self.capacity}."
            )

        def grow(x):
            if x is None:
                return None
            return torch.nn.functional.pad(x, (0, 0, 0, capacity - self.capacity))

        return dataclasses.replace(
            self,
            points=grow(self.points),
            normals=grow(self.normals),
            colors=grow(self.colors),
            features=grow(self.features),
        )

    def append_masked(
        self,
        points: torch.Tensor,
        mask: torch.Tensor,
        normals: Optional[torch.Tensor] = None,
        colors: Optional[torch.Tensor] = None,
        features: Optional[torch.Tensor] = None,
    ) -> "Pointclouds":
        r"""Append the masked rows of ``points (B, M, 3)`` (and of the
        optional per-row ``normals``, ``colors``, ``features``) into the free
        region of the buffers: the destinations are ``num_points +
        cumsum(mask) - 1``, rows past the capacity are dropped and counted in
        ``num_dropped`` when the buffer tracks it. A buffer that this cloud
        does not carry, or a rows argument left None, is passed through.
        Differentiable in the buffers and the rows.

        Functional, as in the JAX package: the result holds new buffers
        (one copy of each, made by the scatter itself), so an earlier map and
        any view of it stay as they were.
        """
        cap = self.capacity
        dest = self.num_points[:, None] + torch.cumsum(mask.to(torch.int64), dim=-1) - 1
        dest = torch.where(mask, dest, torch.full_like(dest, -1))  # dest >= cap drops too

        def scat(buf, new):
            if buf is None or new is None:
                return buf
            return scatter_rows_into(buf, dest, new)

        appended = ((dest >= 0) & (dest < cap)).sum(dim=-1)
        requested = mask.sum(dim=-1)
        return Pointclouds(
            points=scat(self.points, points),
            num_points=self.num_points + appended,
            normals=scat(self.normals, normals),
            colors=scat(self.colors, colors),
            features=scat(self.features, features),
            num_dropped=(None if self.num_dropped is None
                         else self.num_dropped + (requested - appended)),
        )

    def save_ply(self, path: str, index: int = 0, binary: bool = True,
                 color_range: Optional[str] = None) -> None:
        r"""Write batch element ``index``'s live points (with its normals and
        colors where the cloud carries them) to a PLY file, as
        ``gradslam_tpu/structures/pointclouds.py:611`` does; ``color_range``
        as :func:`~gradslam_torch.structures.io.save_ply`."""
        _save_ply(
            path,
            self.points_list[index],
            normals=None if self.normals is None else self.normals_list[index],
            colors=None if self.colors is None else self.colors_list[index],
            binary=binary,
            color_range=color_range,
        )

    def append_points(self, other: "Pointclouds") -> "Pointclouds":
        """Append another cloud's live points (the reference's
        ``append_points``)."""
        return self.append_masked(
            other.points, other.nonpad_mask, normals=other.normals,
            colors=other.colors, features=other.features,
        )
