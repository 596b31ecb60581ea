r"""Batched pointclouds as fixed-capacity padded buffers (PyTorch).

Counterpart of ``gradslam_tpu/structures/pointclouds.py``: a frozen
dataclass of tensors

- ``points`` ``(B, CAP, 3)`` padded point buffer,
- ``num_points`` ``(B,)`` int64 live-point counters,
- optional ``normals``/``colors`` ``(B, CAP, 3)`` and ``features``
  ``(B, CAP, C)``,
- optional ``num_dropped`` ``(B,)`` int64: rows lost to a full buffer.

Host arrays given to the constructor (numpy, JAX arrays) become tensors on
the device of the first tensor field, or on the card when there is none
(:func:`~gradslam_torch.structures.structutils.coerce_torch`): float32
buffers, int64 counters. Every operation returns a new cloud and leaves its
input as it was; the reference's in-place names (``offset_``,
``transform_``, ...) do the same.

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
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from ..geometry.geometryutils import transform_normals, transform_pointcloud
from ..geometry.projutils import homogenize_points, project_points
from ..ops import scatter_cuda
from ..ops.scatter import scatter_rows_into_plain, scatter_rows_plain
from ..utils.precision import fp32_products
from .io import save_ply as _save_ply
from .structutils import coerce_torch, host_tensor, landing_device

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


_FIELDS = ("points", "num_points", "normals", "colors", "features", "num_dropped")
_COUNTERS = ("num_points", "num_dropped")


def _as_operand(x, like: torch.Tensor) -> torch.Tensor:
    """An operand of a cloud operation (tensor, numpy, scalar) as a tensor
    of the cloud's dtype on its device."""
    return torch.as_tensor(coerce_torch(x, np.float32, like.device), dtype=like.dtype,
                           device=like.device)


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
        fields = [getattr(self, name) for name in _FIELDS]
        if not all(v is None or isinstance(v, torch.Tensor) for v in fields):
            device = landing_device(fields)
            for name, value in zip(_FIELDS, fields):
                dtype = np.int64 if name in _COUNTERS else np.float32
                object.__setattr__(self, name, coerce_torch(value, dtype, device))
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

    @classmethod
    def from_list(
        cls,
        points: Sequence,
        normals: Optional[Sequence] = None,
        colors: Optional[Sequence] = None,
        features: Optional[Sequence] = None,
        capacity: Optional[int] = None,
        allow_truncation: bool = False,
        *,
        device: Union[str, torch.device] = "cuda",
    ) -> "Pointclouds":
        r"""A cloud from lists of ragged ``(N_b, 3)`` arrays (numpy, tensors
        or JAX arrays; ``features`` ``(N_b, C)``), padded to ``capacity``
        (the longest cloud by default), on ``device`` (the card by default),
        with int64 counters. A cloud longer than ``capacity`` raises unless
        ``allow_truncation``, which keeps its first ``capacity`` points."""
        if len(points) == 0:
            raise ValueError("points list must be non-empty.")
        counts = [int(np.shape(p)[0]) for p in points]
        cap = capacity if capacity is not None else max(max(counts), 1)
        if max(counts) > cap and not allow_truncation:
            raise ValueError(
                f"cloud with {max(counts)} points exceeds capacity {cap}; "
                "raise capacity or pass allow_truncation=True to keep only "
                "the first `capacity` points."
            )

        def pad(seq):
            if seq is None:
                return None
            rows = [np.asarray(a.detach().cpu() if isinstance(a, torch.Tensor) else a,
                               dtype=np.float32) for a in seq]
            out = np.zeros((len(rows), cap, rows[0].shape[-1]), dtype=np.float32)
            for b, r in enumerate(rows):
                out[b, : min(r.shape[0], cap)] = r[:cap]
            return host_tensor(out, np.float32, device)

        return cls(
            points=pad(points),
            num_points=host_tensor(np.minimum(counts, cap), np.int64, device),
            normals=pad(normals),
            colors=pad(colors),
            features=pad(features),
        )

    def __len__(self) -> int:
        return self.points.shape[0]

    @property
    def capacity(self) -> int:
        return self.points.shape[1]

    @property
    def equisized(self) -> bool:
        """True when every cloud of the batch has as many points (reads the
        counters on the host)."""
        counts = self.num_points.cpu()
        return bool((counts == counts[0]).all()) if counts.numel() else True

    @property
    def points_padded(self) -> torch.Tensor:
        """The ``(B, CAP, 3)`` point buffer."""
        return self.points

    @property
    def normals_padded(self) -> Optional[torch.Tensor]:
        return self.normals

    @property
    def colors_padded(self) -> Optional[torch.Tensor]:
        return self.colors

    @property
    def features_padded(self) -> Optional[torch.Tensor]:
        return self.features

    @property
    def num_features(self) -> int:
        """The feature channels, 0 when the cloud has none."""
        return 0 if self.features is None else self.features.shape[-1]

    @property
    def num_points_per_pointcloud(self) -> torch.Tensor:
        """The ``(B,)`` live point counts."""
        return self.num_points

    @property
    def has_points(self) -> bool:
        """True when any cloud of the batch has a point (reads the counters
        on the host)."""
        return bool((self.num_points > 0).any())

    @property
    def has_normals(self) -> bool:
        return self.normals is not None

    @property
    def has_colors(self) -> bool:
        return self.colors is not None

    @property
    def has_features(self) -> bool:
        return self.features is not None

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

    def __getitem__(self, index) -> "Pointclouds":
        """The clouds of the batch rows ``index`` selects. An int keeps the
        batch dim (``-1`` is the last row) and raises ``IndexError`` out of
        range."""
        if isinstance(index, int):
            B = len(self)
            if not -B <= index < B:
                raise IndexError(f"Batch index {index} out of range for {B} pointclouds.")
            index = slice(index, index + 1 if index != -1 else None)
        return Pointclouds(**{name: None if getattr(self, name) is None
                              else getattr(self, name)[index] for name in _FIELDS})

    def _map(self, fn) -> "Pointclouds":
        return Pointclouds(**{name: None if getattr(self, name) is None
                              else fn(getattr(self, name)) for name in _FIELDS})

    # ------------------------------------------------------------------ #
    # Geometric operations: each returns a new cloud
    # ------------------------------------------------------------------ #
    def offset(self, offsets) -> "Pointclouds":
        """Translate the live points by ``offsets`` (broadcast against
        ``(B, CAP, 3)``); the padding stays zero."""
        offsets = _as_operand(offsets, self.points)
        mask = self.nonpad_mask[..., None].to(self.points.dtype)
        return dataclasses.replace(self, points=self.points + offsets * mask)

    def scale(self, scales) -> "Pointclouds":
        """Scale the points by ``scales`` (broadcast against ``(B, CAP, 3)``)."""
        return dataclasses.replace(self, points=self.points * _as_operand(scales, self.points))

    @fp32_products()
    def rotate(self, rmat, *, pre_multiplication: bool = True) -> "Pointclouds":
        """Rotate points and normals by ``(3, 3)`` or ``(B, 3, 3)``
        matrices: ``R @ p`` or, with ``pre_multiplication=False``,
        ``p @ R`` (the ``@`` operator's)."""
        rmat = _as_operand(rmat, self.points)
        if rmat.shape[-2:] != (3, 3):
            raise ValueError(f"rmat must have shape (*, 3, 3). Got {tuple(rmat.shape)}.")
        batch = "" if rmat.ndim == 2 else "b"
        spec = (f"{batch}ij,bnj->bni" if pre_multiplication else f"bnj,{batch}jk->bnk")

        def rot(x):
            return torch.einsum(spec, *((rmat, x) if pre_multiplication else (x, rmat)))

        return dataclasses.replace(
            self, points=rot(self.points),
            normals=None if self.normals is None else rot(self.normals))

    @fp32_products()
    def transform(self, transform, *, pre_multiplication: bool = True) -> "Pointclouds":
        """Apply ``(4, 4)`` or ``(B, 4, 4)`` rigid transforms: ``R p + t``
        with the padding kept at zero and the normals rotated, not moved;
        with ``pre_multiplication=False``, ``p @ R`` then the offset by
        ``t`` (the ``@`` operator's)."""
        transform = _as_operand(transform, self.points)
        if transform.shape[-2:] != (4, 4):
            raise ValueError(
                f"transform must have shape (*, 4, 4). Got {tuple(transform.shape)}."
            )
        if not pre_multiplication:
            tvec = transform[..., :3, 3]
            if tvec.ndim == 2:
                tvec = tvec[:, None]
            return self.rotate(transform[..., :3, :3], pre_multiplication=False).offset(tvec)
        moved = transform_pointcloud(self.points, transform)
        return dataclasses.replace(
            self,
            points=torch.where(self.nonpad_mask[..., None], moved, torch.zeros_like(moved)),
            normals=None if self.normals is None else transform_normals(self.normals, transform),
        )

    @fp32_products()
    def pinhole_projection(self, intrinsics) -> "Pointclouds":
        """Project the points through ``(4, 4)`` or ``(B, 4, 4)``
        intrinsics onto the z = 1 plane: each live point becomes
        ``(u, v, 1)``, the padding stays zero."""
        intrinsics = _as_operand(intrinsics, self.points)
        if intrinsics.shape[-2:] != (4, 4):
            raise ValueError(
                f"intrinsics must have shape (*, 4, 4). Got {tuple(intrinsics.shape)}."
            )
        projected = homogenize_points(project_points(self.points, intrinsics))
        return dataclasses.replace(
            self, points=projected * self.nonpad_mask[..., None].to(projected.dtype))

    def __add__(self, other):
        return self.offset(other)

    def __sub__(self, other):
        return self.offset(-_as_operand(other, self.points))

    def __mul__(self, other):
        return self.scale(other)

    def __truediv__(self, other):
        return self.scale(1.0 / _as_operand(other, self.points))

    def __matmul__(self, other):
        """``pc @ R`` with ``(3, 3)``/``(B, 3, 3)`` rotations or ``pc @ T``
        with ``(4, 4)``/``(B, 4, 4)`` transforms, post-multiplying points
        and normals."""
        other = _as_operand(other, self.points)
        if other.ndim not in (2, 3) or other.shape[-2:] not in ((3, 3), (4, 4)):
            raise ValueError(
                f"Unsupported shape for Pointclouds @ operand: {tuple(other.shape)}\n"
                "Use tensor of shape (3, 3) or (B, 3, 3) for rotations, or "
                "(4, 4) or (B, 4, 4) for transformations"
            )
        if other.shape[-2:] == (3, 3):
            return self.rotate(other, pre_multiplication=False)
        return self.transform(other, pre_multiplication=False)

    # The reference's in-place names. The cloud is frozen and may be shared
    # with an earlier map, so these return the new cloud and mutate nothing.
    def offset_(self, offsets) -> "Pointclouds":
        """:meth:`offset`, returning the new cloud (nothing is mutated)."""
        return self.offset(offsets)

    def scale_(self, scales) -> "Pointclouds":
        """:meth:`scale`, returning the new cloud (nothing is mutated)."""
        return self.scale(scales)

    def rotate_(self, rmat) -> "Pointclouds":
        """:meth:`rotate`, returning the new cloud (nothing is mutated)."""
        return self.rotate(rmat)

    def transform_(self, transform) -> "Pointclouds":
        """:meth:`transform`, returning the new cloud (nothing is mutated)."""
        return self.transform(transform)

    def pinhole_projection_(self, intrinsics) -> "Pointclouds":
        """:meth:`pinhole_projection`, returning the new cloud (nothing is
        mutated)."""
        return self.pinhole_projection(intrinsics)

    # ------------------------------------------------------------------ #
    # Tensor semantics
    # ------------------------------------------------------------------ #
    def clone(self) -> "Pointclouds":
        """A copy with new buffers (gradients flow through it)."""
        return self._map(torch.clone)

    def detach(self) -> "Pointclouds":
        """The same values, cut from the autograd graph."""
        return self._map(torch.Tensor.detach)

    def to(self, device) -> "Pointclouds":
        """Every buffer on ``device``."""
        return self._map(lambda t: t.to(device))

    def cpu(self) -> "Pointclouds":
        return self.to("cpu")

    def cuda(self) -> "Pointclouds":
        """Every buffer on the card, ``torch.device("cuda")``."""
        return self.to(torch.device("cuda"))

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

    def open3d(self, index: int):
        """Batch element ``index`` as an ``open3d.geometry.PointCloud``
        (colors above 1 taken as 0-255). Needs open3d."""
        import open3d as o3d

        pcd = o3d.geometry.PointCloud()
        pcd.points = o3d.utility.Vector3dVector(self.points_list[index].astype(np.float64))
        if self.normals is not None:
            pcd.normals = o3d.utility.Vector3dVector(
                self.normals_list[index].astype(np.float64))
        if self.colors is not None:
            colors = self.colors_list[index].astype(np.float64)
            if colors.size and colors.max() > 1.001:
                colors = colors / 255.0
            pcd.colors = o3d.utility.Vector3dVector(colors)
        return pcd

    def plotly(
        self,
        index: int,
        include_colors: bool = True,
        max_num_points: Optional[int] = 200000,
        as_figure: bool = True,
        point_size: int = 2,
    ):
        r"""Batch element ``index`` as a plotly ``Scatter3d`` (or a
        ``Figure`` around it, axes hidden): a random subset above
        ``max_num_points``, colors in 0-1 scaled to 0-255. Needs plotly."""
        if not isinstance(index, int):
            raise TypeError(f"Index should be int, but was {type(index)}.")
        import plotly.graph_objects as go

        pts = self.points_list[index]
        subsample = max_num_points is not None and max_num_points < pts.shape[0]
        if subsample:
            point_inds = np.random.permutation(pts.shape[0])[:max_num_points]
            pts = pts[point_inds]
        marker = {"size": point_size}
        if self.colors is not None and include_colors:
            colors = self.colors_list[index]
            if subsample:
                colors = colors[point_inds]
            if colors.size and colors.max() < 1.1:
                colors = colors * 255.0
            colors = np.clip(colors, 0.0, 255.0).astype(np.uint8)
            marker["color"] = [f"rgb({r},{g},{b})" for r, g, b in colors]
        scatter = go.Scatter3d(x=pts[:, 0], y=pts[:, 1], z=pts[:, 2], mode="markers",
                               marker=marker)
        if not as_figure:
            return scatter
        hidden = dict(showticklabels=False, showgrid=False, zeroline=False, visible=False)
        fig = go.Figure(data=[scatter])
        fig.update_layout(showlegend=False, scene=dict(xaxis=hidden, yaxis=hidden, zaxis=hidden))
        return fig
