r"""Batched RGB-D frame sequences as a frozen dataclass of tensors.

Counterpart of ``gradslam_tpu/structures/rgbdimages.py``. The canonical
layout is channels-last ``(B, L, H, W, C)``; a channels-first instance
(``channels_first=True``, ``(B, L, C, H, W)``) exists for the reference's
API and converts with :meth:`RGBDImages.to_channels_last`. An optional
``feature_image`` plane ``(B, L, H, W, F)`` (semantic one-hots, learned
descriptors) rides along and is fused into the map's feature channels by
``PointFusion(feature_channels=F)``. The derived maps (``vertex_map``,
``normal_map``, ``global_*``) read the channels-last layout and follow the
container's layout, with the JAX package's semantics below. Host arrays
given to the constructor (numpy, JAX arrays) become float32 tensors on the
device of the first tensor field, or on the card when there is none
(:func:`~gradslam_torch.structures.structutils.coerce_torch`).

- ``vertex_map``: ``(Kinv[:3, :3] @ [u, v, 1]) * depth``, zeroed where the
  depth is not positive;
- ``global_vertex_map``: ``R @ v + t``;
- ``normal_map``: cross product of pitch-k forward differences along width
  and height (last k rows/cols replicate the final difference), degenerate
  pixels zeroed by a test in the squared domain;
- ``global_normal_map``: ``R @ n``.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

import numpy as np

from ..geometry.geometryutils import create_meshgrid
from ..geometry.projutils import inverse_intrinsics
from .structutils import coerce_torch, landing_device

__all__ = ["RGBDImages"]


def _last(x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if x is None else torch.movedim(x, 2, -1)


def _first(x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if x is None else torch.movedim(x, -1, 2)


_ARRAYS = ("rgb_image", "depth_image", "intrinsics", "poses", "feature_image")


@dataclass(frozen=True)
class RGBDImages:
    # Declared in the JAX package's order, so positional calls bind alike:
    # (rgb, depth, K, poses, channels_first) is the reference's order.
    rgb_image: torch.Tensor  # (B, L, H, W, 3), or (B, L, 3, H, W) channels-first
    depth_image: torch.Tensor  # (B, L, H, W, 1), or (B, L, 1, H, W)
    intrinsics: torch.Tensor  # (B, 1, 4, 4)
    poses: Optional[torch.Tensor] = None  # (B, L, 4, 4)
    channels_first: bool = False
    feature_image: Optional[torch.Tensor] = None  # (B, L, H, W, F), or (B, L, F, H, W)
    # Finite-difference baseline (pixels) of ``normal_map``; 1 differences
    # adjacent pixels exactly as the reference does.
    normal_pitch: int = 1

    def __post_init__(self):
        arrays = [getattr(self, name) for name in _ARRAYS]
        if not all(v is None or isinstance(v, torch.Tensor) for v in arrays):
            device = landing_device(arrays)
            for name, value in zip(_ARRAYS, arrays):
                object.__setattr__(self, name, coerce_torch(value, np.float32, device))
        if not isinstance(self.normal_pitch, int) or self.normal_pitch < 1:
            raise ValueError(
                f"normal_pitch must be an int >= 1. Got {self.normal_pitch}."
            )
        rgb = self.rgb_image
        cdim = self.cdim
        layout = "(B, L, 3, H, W)" if self.channels_first else "(B, L, H, W, 3)"
        if rgb.ndim != 5:
            raise ValueError(f"rgb_image must have shape {layout}. Got {tuple(rgb.shape)}.")
        if rgb.shape[cdim] != 3:
            if not self.channels_first and rgb.shape[2] == 3:
                raise ValueError(
                    "rgb_image appears channels-first; use "
                    "RGBDImages.from_channels_first or channels_first=True."
                )
            raise ValueError(f"rgb_image must have shape {layout}. Got {tuple(rgb.shape)}.")
        expected_depth = tuple(rgb.shape[:cdim]) + (1,) + tuple(rgb.shape[cdim + 1:])
        if tuple(self.depth_image.shape) != expected_depth:
            raise ValueError(
                f"depth_image must have shape {expected_depth} matching rgb "
                f"{tuple(rgb.shape)}. Got {tuple(self.depth_image.shape)}."
            )
        if self.intrinsics.shape != (rgb.shape[0], 1, 4, 4):
            raise ValueError(
                f"intrinsics must have shape (B, 1, 4, 4) = ({rgb.shape[0]}, 1, 4, 4). "
                f"Got {tuple(self.intrinsics.shape)}."
            )
        if self.poses is not None and self.poses.shape != rgb.shape[:2] + (4, 4):
            raise ValueError(
                f"poses must have shape (B, L, 4, 4). Got {tuple(self.poses.shape)}."
            )
        feat = self.feature_image
        if feat is not None:
            dims = (0, 1, 3, 4) if self.channels_first else (0, 1, 2, 3)  # all but channels
            if feat.ndim != 5 or [feat.shape[d] for d in dims] != [rgb.shape[d] for d in dims]:
                flayout = "(B, L, F, H, W)" if self.channels_first else "(B, L, H, W, F)"
                raise ValueError(
                    f"feature_image must have shape {flayout} matching rgb "
                    f"{tuple(rgb.shape)}. Got {tuple(feat.shape)}."
                )

    @classmethod
    def from_channels_first(cls, rgb_image, depth_image, intrinsics, poses=None,
                            feature_image=None) -> "RGBDImages":
        """A channels-last instance from the reference's channels-first
        tensors (or host arrays) ``(B, L, C, H, W)``."""
        arrays = (rgb_image, depth_image, intrinsics, poses, feature_image)
        device = landing_device(arrays)
        rgb_image, depth_image, intrinsics, poses, feature_image = (
            coerce_torch(a, np.float32, device) for a in arrays)
        return cls(_last(rgb_image), _last(depth_image), intrinsics, poses,
                   feature_image=_last(feature_image))

    # ------------------------------------------------------------------ #
    # Shape, device, indexing
    # ------------------------------------------------------------------ #
    @property
    def shape(self) -> Tuple[int, int, int, int]:
        """``(B, L, H, W)`` in either layout."""
        B, L = self.rgb_image.shape[:2]
        H, W = self.rgb_image.shape[3:5] if self.channels_first else self.rgb_image.shape[2:4]
        return (B, L, H, W)

    @property
    def h(self) -> int:
        """The frame height."""
        return self.shape[2]

    @property
    def w(self) -> int:
        """The frame width."""
        return self.shape[3]

    @property
    def has_poses(self) -> bool:
        """True when poses are attached."""
        return self.poses is not None

    @property
    def cdim(self) -> int:
        """The channel dimension: 2 channels-first, else 4."""
        return 2 if self.channels_first else 4

    @property
    def has_features(self) -> bool:
        """True when a ``feature_image`` plane is attached."""
        return self.feature_image is not None

    @property
    def feature_channels(self) -> int:
        """The feature plane's channel count (0 when none is attached)."""
        return 0 if self.feature_image is None else self.feature_image.shape[self.cdim]

    def __len__(self) -> int:
        return self.rgb_image.shape[0]

    @property
    def device(self) -> torch.device:
        return self.rgb_image.device

    @property
    def dtype(self) -> torch.dtype:
        return self.depth_image.dtype

    def __getitem__(self, index) -> "RGBDImages":
        """Batch/sequence indexing that keeps both dims: an int index selects
        one element and leaves a dim of size 1 (``frames[:, s]``)."""
        if not isinstance(index, tuple):
            index = (index,)
        if len(index) > 2:
            raise IndexError("Only batch and sequence dims are indexable.")

        def norm(i):
            if isinstance(i, int):
                return slice(i, i + 1 if i != -1 else None)
            return i

        bidx = norm(index[0])
        sidx = norm(index[1]) if len(index) > 1 else slice(None)
        return dataclasses.replace(
            self,
            rgb_image=self.rgb_image[bidx, sidx],
            depth_image=self.depth_image[bidx, sidx],
            intrinsics=self.intrinsics[bidx],
            poses=None if self.poses is None else self.poses[bidx, sidx],
            feature_image=None if self.feature_image is None
            else self.feature_image[bidx, sidx],
        )

    def with_poses(self, poses) -> "RGBDImages":
        """Copy with ``poses (B, L, 4, 4)`` attached (a host array lands on
        the frames' device)."""
        return dataclasses.replace(self, poses=coerce_torch(poses, np.float32, self.device))

    # ------------------------------------------------------------------ #
    # Tensor semantics
    # ------------------------------------------------------------------ #
    def _map(self, fn) -> "RGBDImages":
        return dataclasses.replace(self, **{name: None if getattr(self, name) is None
                                            else fn(getattr(self, name)) for name in _ARRAYS})

    def clone(self) -> "RGBDImages":
        """A copy with new tensors (gradients flow through it)."""
        return self._map(torch.clone)

    def detach(self) -> "RGBDImages":
        """The same values, cut from the autograd graph."""
        return self._map(torch.Tensor.detach)

    def to(self, device) -> "RGBDImages":
        """Every tensor on ``device``."""
        return self._map(lambda t: t.to(device))

    def cpu(self) -> "RGBDImages":
        return self.to("cpu")

    def cuda(self) -> "RGBDImages":
        """Every tensor on the card, ``torch.device("cuda")``."""
        return self.to(torch.device("cuda"))

    def _to_layout(self, x: torch.Tensor) -> torch.Tensor:
        """A channels-last derived map in this container's layout."""
        return _first(x) if self.channels_first else x

    # ------------------------------------------------------------------ #
    # Layout
    # ------------------------------------------------------------------ #
    def to_channels_last(self) -> "RGBDImages":
        """The ``(B, L, H, W, C)`` layout; ``self`` if already in it."""
        if not self.channels_first:
            return self
        return dataclasses.replace(
            self, rgb_image=_last(self.rgb_image), depth_image=_last(self.depth_image),
            feature_image=_last(self.feature_image), channels_first=False)

    def to_channels_first(self) -> "RGBDImages":
        """The ``(B, L, C, H, W)`` layout; ``self`` if already in it."""
        if self.channels_first:
            return self
        return dataclasses.replace(
            self, rgb_image=_first(self.rgb_image), depth_image=_first(self.depth_image),
            feature_image=_first(self.feature_image), channels_first=True)

    def to_channels_last_(self) -> "RGBDImages":
        """The reference's in-place name of :meth:`to_channels_last`; the
        structure is frozen, so it returns the converted copy."""
        return self.to_channels_last()

    def to_channels_first_(self) -> "RGBDImages":
        """The reference's in-place name of :meth:`to_channels_first`; the
        structure is frozen, so it returns the converted copy."""
        return self.to_channels_first()

    def _derived(self, name: str) -> torch.Tensor:
        """A derived map of a channels-first instance: computed from the
        channels-last layout, returned channels-first."""
        return self._to_layout(getattr(self.to_channels_last(), name))

    @property
    def rgb_image_channels_first(self) -> torch.Tensor:
        """The colours as ``(B, L, 3, H, W)`` in either layout (a view)."""
        return self.rgb_image if self.channels_first else _first(self.rgb_image)

    @property
    def depth_image_channels_first(self) -> torch.Tensor:
        """The depths as ``(B, L, 1, H, W)`` in either layout (a view)."""
        return self.depth_image if self.channels_first else _first(self.depth_image)

    # ------------------------------------------------------------------ #
    # Derived maps
    # ------------------------------------------------------------------ #
    @property
    def valid_depth_mask(self) -> torch.Tensor:
        """``(B, L, H, W, 1)`` bool, True where depth > 0 (the channel
        dimension follows the layout)."""
        return self.depth_image > 0

    @property
    def pixel_pos(self) -> torch.Tensor:
        """``(B, L, H, W, 3)`` homogeneous pixel coordinates ``(u, v, 1)``
        (u = column, v = row)."""
        if self.channels_first:
            return self._derived("pixel_pos")
        B, L, H, W = self.shape
        grid = create_meshgrid(
            H, W, normalized_coords=False, device=self.device, dtype=self.dtype
        )[0]
        pix = torch.stack(
            [grid[..., 1], grid[..., 0], torch.ones_like(grid[..., 0])], dim=-1
        )
        return pix.expand(B, L, H, W, 3)

    @property
    def vertex_map(self) -> torch.Tensor:
        """``(B, L, H, W, 3)`` camera-frame back-projection."""
        if self.channels_first:
            return self._derived("vertex_map")
        B, L = self.shape[:2]
        Kinv = inverse_intrinsics(self.intrinsics)[..., :3, :3].expand(B, L, 3, 3)
        v = torch.einsum("bsjc,bshwc->bshwj", Kinv, self.pixel_pos) * self.depth_image
        return v * self.valid_depth_mask.to(v.dtype)

    @property
    def global_vertex_map(self) -> torch.Tensor:
        """``(B, L, H, W, 3)`` world-frame vertices."""
        if self.channels_first:
            return self._derived("global_vertex_map")
        if self.poses is None:
            return self.vertex_map
        rmat = self.poses[..., :3, :3]
        tvec = self.poses[..., :3, 3]
        out = torch.einsum("bsij,bshwj->bshwi", rmat, self.vertex_map)
        out = out + tvec[:, :, None, None, :]
        return out * self.valid_depth_mask.to(out.dtype)

    @property
    def normal_map(self) -> torch.Tensor:
        """``(B, L, H, W, 3)`` camera-frame normals from pitch-k finite
        differences."""
        if self.channels_first:
            return self._derived("normal_map")
        v = self.vertex_map
        k = self.normal_pitch
        H, W = v.shape[-3], v.shape[-2]
        if k >= H or k >= W:
            raise ValueError(
                f"normal_pitch ({k}) must be smaller than the image "
                f"dimensions ({H}x{W})."
            )

        def pad_tail(d, dim):
            tail = d.narrow(dim, d.shape[dim] - 1, 1)
            return torch.cat([d] + [tail] * k, dim=dim)

        dhoriz = pad_tail(v[..., k:, :] - v[..., :-k, :], -2)
        dverti = pad_tail(v[..., k:, :, :] - v[..., :-k, :, :], -3)
        normal = torch.linalg.cross(dhoriz, dverti, dim=-1)
        # Parallel tangents map to a zero normal: ||a x b|| = |a||b| sin,
        # and sin below 1e-6 is parallel in float32. Gated in the squared
        # domain with a double where, so the sqrt never sees 0.
        norm_sq = torch.sum(normal * normal, dim=-1, keepdim=True)
        scale_sq = torch.sum(dhoriz * dhoriz, dim=-1, keepdim=True) * torch.sum(
            dverti * dverti, dim=-1, keepdim=True
        )
        degenerate = norm_sq <= 1e-12 * scale_sq
        norm = torch.sqrt(torch.where(degenerate, torch.ones_like(norm_sq), norm_sq))
        normal = torch.where(degenerate, torch.zeros_like(normal), normal / norm)
        return normal * self.valid_depth_mask.to(normal.dtype)

    @property
    def global_normal_map(self) -> torch.Tensor:
        """``(B, L, H, W, 3)`` world-frame normals."""
        if self.channels_first:
            return self._derived("global_normal_map")
        if self.poses is None:
            return self.normal_map
        rmat = self.poses[..., :3, :3]
        return torch.einsum("bsij,bshwj->bshwi", rmat, self.normal_map)

    # ------------------------------------------------------------------ #
    # Viewers (need plotly)
    # ------------------------------------------------------------------ #
    def plotly(
        self,
        index: int,
        include_depth: bool = True,
        as_figure: bool = True,
        ms_per_frame: int = 50,
    ):
        r"""Frame-by-frame RGB (and depth) animation of batch element
        ``index`` with a slider and play/stop buttons, the reference's
        viewer: frames ``{'name', 'data', 'traces'}``, depth shown scaled
        by ``10^floor(log10(255 / max_depth))``. ``as_figure=False``
        returns the frames list. Needs plotly."""
        if not isinstance(index, int):
            raise TypeError(f"Index should be int, but was {type(index)}.")
        from plotly.subplots import make_subplots

        from .structutils import animation_slider, animation_updatemenus, numpy_to_plotly_image

        frames_cl = self.to_channels_last()
        rgb = frames_cl.rgb_image[index].detach().cpu().numpy().astype(np.float32)
        if rgb.max() < 1.1:
            rgb = rgb * 255
        rgb = np.clip(rgb, 0.0, 255.0).astype(np.uint8)
        image_rgb = [numpy_to_plotly_image(im, i) for i, im in enumerate(rgb)]
        if not include_depth:
            frames = [{"data": [frame], "name": i} for i, frame in enumerate(image_rgb)]
        else:
            depth = frames_cl.depth_image[index, ..., 0].detach().cpu().numpy().astype(np.float32)
            dmax = float(depth.max())
            scale = 10 ** math.floor(math.log10(255.0 / dmax)) if dmax > 0 else 1
            image_depth = [numpy_to_plotly_image(d, i, True, scale)
                           for i, d in enumerate((depth * scale).astype(np.uint8))]
            frames = [{"name": i, "data": list(frame), "traces": [0, 1]}
                      for i, frame in enumerate(zip(image_rgb, image_depth))]
        if not as_figure:
            return frames
        if not include_depth:
            fig = make_subplots(rows=1, cols=1, subplot_titles=("RGB",))
            fig.add_traces(frames[0]["data"][0])
        else:
            fig = make_subplots(rows=2, cols=1, subplot_titles=("RGB", "Depth"),
                                shared_xaxes=True, shared_yaxes=False, vertical_spacing=0.1)
            fig.add_trace(frames[0]["data"][0], row=1, col=1)
            fig.add_trace(frames[0]["data"][1], row=2, col=1)
            fig.update_layout(scene=dict(aspectmode="data"))
            fig.update_layout(autosize=False, height=1080)
        fig.update(frames=frames)
        fig.update_layout(updatemenus=animation_updatemenus(ms_per_frame),
                          sliders=animation_slider(self.shape[1]))
        return fig

    def plotly_vertex_scatter(self, index: int, ds_ratio: int = 4):
        """3-D plotly scatter of batch element ``index``'s global vertex
        map, every ``ds_ratio``-th pixel with valid depth. Needs plotly."""
        import plotly.graph_objects as go

        frames_cl = self.to_channels_last()
        every = (slice(None), slice(None, None, ds_ratio), slice(None, None, ds_ratio))
        verts = frames_cl.global_vertex_map[index][every].detach().cpu().numpy()
        cols = frames_cl.rgb_image[index][every].detach().cpu().numpy()
        mask = frames_cl.valid_depth_mask[index][every][..., 0].cpu().numpy()
        pts, rgb = verts[mask], cols[mask]
        if rgb.size and rgb.max() <= 1.001:
            rgb = rgb * 255.0
        rgb = rgb.astype(np.uint8)
        scatter = go.Scatter3d(
            x=pts[:, 0], y=pts[:, 1], z=pts[:, 2], mode="markers",
            marker=dict(size=2, color=[f"rgb({r},{g},{b})" for r, g, b in rgb]),
        )
        return go.Figure(data=[scatter])
