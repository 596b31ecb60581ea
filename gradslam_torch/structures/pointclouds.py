r"""Batched pointclouds as fixed-capacity padded buffers (PyTorch).

Counterpart of ``gradslam_tpu/structures/pointclouds.py``: a frozen
dataclass of tensors

- ``points`` ``(B, CAP, 3)`` padded point buffer,
- ``num_points`` ``(B,)`` int64 live-point counters,
- optional ``normals``/``colors`` ``(B, CAP, 3)`` and ``features``
  ``(B, CAP, C)``,
- optional ``num_dropped`` ``(B,)`` int64: rows lost to a full buffer.

Writes that JAX parks past the end of an array and drops with
``mode="drop"`` go here to trash rows past the end of a larger buffer, which
is sliced off afterwards: every destination is unique, so the writes are
deterministic, and no index is ever out of bounds.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

__all__ = ["Pointclouds", "compact_masked", "gather_rows", "scatter_rows"]


def scatter_rows(
    size: int, dest: torch.Tensor, values: torch.Tensor, fill=0
) -> torch.Tensor:
    r"""Write ``values (B, M, *C)`` to rows ``dest (B, M)`` of a new
    ``(B, size, *C)`` buffer filled with ``fill``.

    Destinations ``>= size`` are trash rows: the buffer is allocated with
    ``max(dest) < size + M`` rows (callers park unused rows at unique slots
    ``size + i``) and cut back to ``size``. Destinations must be unique.
    """
    B, M = dest.shape
    out = torch.full(
        (B, size + M) + tuple(values.shape[2:]), fill,
        dtype=values.dtype, device=values.device,
    )
    bidx = torch.arange(B, device=dest.device)[:, None].expand(B, M)
    out = out.index_put((bidx, dest), values, accumulate=False)
    return out[:, :size].contiguous()


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of ``x (B, M, C)`` at ``idx (B, N)`` (any integer dtype):
    ``(B, N, C)``."""
    return torch.gather(x, 1, idx.long()[..., None].expand(-1, -1, x.shape[-1]))


def compact_masked(values: torch.Tensor, mask: torch.Tensor, capacity: int):
    r"""Compact the masked rows of ``values (B, M, C)`` to the front of a
    ``(B, capacity, C)`` buffer, in order. Returns ``(buffer, counts)``;
    rows past ``capacity`` are dropped."""
    B, M = mask.shape
    rank = torch.cumsum(mask.to(torch.int64), dim=-1) - 1
    oob = capacity + torch.arange(M, device=mask.device)[None, :]
    dest = torch.where(mask & (rank < capacity), rank, oob)
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
        device,
        dtype=torch.float32,
        has_normals: bool = True,
        has_colors: bool = True,
        feature_dim: Optional[int] = 1,
    ) -> "Pointclouds":
        """An empty map buffer that tracks ``num_dropped``."""

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
