r"""Batched RGB-D frame sequences as a frozen dataclass of tensors.

Counterpart of ``gradslam_tpu/structures/rgbdimages.py``. Layout is
channels-last ``(B, L, H, W, C)``; the derived maps (``vertex_map``,
``normal_map``, ``global_*``) are pure functions of the fields with the JAX
package's semantics:

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
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from ..geometry.geometryutils import create_meshgrid
from ..geometry.projutils import inverse_intrinsics

__all__ = ["RGBDImages"]


@dataclass(frozen=True)
class RGBDImages:
    rgb_image: torch.Tensor  # (B, L, H, W, 3)
    depth_image: torch.Tensor  # (B, L, H, W, 1)
    intrinsics: torch.Tensor  # (B, 1, 4, 4)
    poses: Optional[torch.Tensor] = None  # (B, L, 4, 4)
    # Finite-difference baseline (pixels) of ``normal_map``; 1 differences
    # adjacent pixels exactly as the reference does.
    normal_pitch: int = 1

    def __post_init__(self):
        if not isinstance(self.normal_pitch, int) or self.normal_pitch < 1:
            raise ValueError(
                f"normal_pitch must be an int >= 1. Got {self.normal_pitch}."
            )
        rgb = self.rgb_image
        if rgb.ndim != 5 or rgb.shape[4] != 3:
            raise ValueError(
                f"rgb_image must have shape (B, L, H, W, 3). Got {tuple(rgb.shape)}."
            )
        if self.depth_image.shape != rgb.shape[:4] + (1,):
            raise ValueError(
                f"depth_image must have shape {tuple(rgb.shape[:4]) + (1,)} "
                f"matching rgb. Got {tuple(self.depth_image.shape)}."
            )
        if self.intrinsics.shape != (rgb.shape[0], 1, 4, 4):
            raise ValueError(
                f"intrinsics must have shape ({rgb.shape[0]}, 1, 4, 4). "
                f"Got {tuple(self.intrinsics.shape)}."
            )
        if self.poses is not None and self.poses.shape != rgb.shape[:2] + (4, 4):
            raise ValueError(
                f"poses must have shape (B, L, 4, 4). Got {tuple(self.poses.shape)}."
            )

    # ------------------------------------------------------------------ #
    # Shape, device, indexing
    # ------------------------------------------------------------------ #
    @property
    def shape(self) -> Tuple[int, int, int, int]:
        """``(B, L, H, W)``."""
        B, L, H, W, _ = self.rgb_image.shape
        return (B, L, H, W)

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
        )

    def with_poses(self, poses: torch.Tensor) -> "RGBDImages":
        """Copy with ``poses (B, L, 4, 4)`` attached."""
        return dataclasses.replace(self, poses=poses)

    # ------------------------------------------------------------------ #
    # Derived maps
    # ------------------------------------------------------------------ #
    @property
    def valid_depth_mask(self) -> torch.Tensor:
        """``(B, L, H, W, 1)`` bool, True where depth > 0."""
        return self.depth_image > 0

    @property
    def pixel_pos(self) -> torch.Tensor:
        """``(B, L, H, W, 3)`` homogeneous pixel coordinates ``(u, v, 1)``
        (u = column, v = row)."""
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
        B, L = self.shape[:2]
        Kinv = inverse_intrinsics(self.intrinsics)[..., :3, :3].expand(B, L, 3, 3)
        v = torch.einsum("bsjc,bshwc->bshwj", Kinv, self.pixel_pos) * self.depth_image
        return v * self.valid_depth_mask.to(v.dtype)

    @property
    def global_vertex_map(self) -> torch.Tensor:
        """``(B, L, H, W, 3)`` world-frame vertices."""
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
        if self.poses is None:
            return self.normal_map
        rmat = self.poses[..., :3, :3]
        return torch.einsum("bsij,bshwj->bshwi", rmat, self.normal_map)
