"""Helpers shared by the port's example CLIs."""

from __future__ import annotations

import torch

from gradslam_torch import RGBDImages


def batch_frames(samples, device) -> RGBDImages:
    r"""Stack dataset samples ``(colors, depths, intrinsics, poses, ...)``
    into one batch of :class:`RGBDImages` on ``device``."""
    colors = torch.stack([s[0] for s in samples]).to(device)
    depths = torch.stack([s[1] for s in samples]).to(device)
    intrinsics = torch.stack([s[2][None] for s in samples]).to(device)
    poses = torch.stack([s[3] for s in samples]).to(device)
    return RGBDImages(colors, depths, intrinsics, poses)


def show(pointclouds, index: int = 0) -> None:
    """Draw batch element ``index`` of a map with open3d (``--visualize``;
    open3d is imported only here)."""
    import numpy as np
    import open3d as o3d

    pcd = o3d.geometry.PointCloud()
    pcd.points = o3d.utility.Vector3dVector(np.asarray(pointclouds.points_list[index], np.float64))
    if pointclouds.normals is not None:
        pcd.normals = o3d.utility.Vector3dVector(
            np.asarray(pointclouds.normals_list[index], np.float64))
    if pointclouds.colors is not None:
        colors = np.asarray(pointclouds.colors_list[index], np.float64)
        if colors.size and colors.max() > 1.001:
            colors = colors / 255.0
        pcd.colors = o3d.utility.Vector3dVector(colors)
    o3d.visualization.draw_geometries([pcd])
