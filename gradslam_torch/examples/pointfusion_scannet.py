r"""PointFusion on a ScanNet scene sequence (PyTorch port).

Counterpart of ``examples/pointfusion_scannet.py``, with the same flags and
output: load a scene sequence, run PointFusion and print the map count;
with ``--fuse-labels`` the scannet20 labels are fused into the map as
one-hot feature channels and the fused map's class counts are printed. The
colour frames are JPEG, read through Pillow. Runs on the card unless
``--cpu`` is given:

    python -m gradslam_torch.examples.pointfusion_scannet \
        --dataset_path /data/scannet/scans --seqmeta_path /data/scannet/seqmeta \
        --start 0 --end 4 --fuse-labels

``main(argv)`` returns ``(pointclouds, recovered_poses)``.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from gradslam_torch import PointFusion, RGBDImages
from gradslam_torch.datasets import Scannet
from gradslam_torch.datasets.datautils import labels_to_onehot
from gradslam_torch.examples._common import show

parser = argparse.ArgumentParser()
parser.add_argument("--dataset_path", type=str, required=True,
                    help="Path to extracted scans (sceneXXXX_XX dirs).")
parser.add_argument("--seqmeta_path", type=str, required=True,
                    help="Path to sequence-association metadata dir.")
parser.add_argument("--scenes", type=str, default=None,
                    help="Comma-separated scene names or a split .txt file.")
parser.add_argument("--odometry", type=str, default="gt", choices=["gt", "icp", "gradicp"])
parser.add_argument("--start", type=int, default=0)
parser.add_argument("--end", type=int, default=4)
parser.add_argument("--height", type=int, default=240)
parser.add_argument("--width", type=int, default=320)
parser.add_argument(
    "--fuse-labels", action="store_true",
    help="Fuse the scannet20 semantic labels into the map (one-hot feature "
    "channels, confidence-weighted). Prints the fused per-class point counts.",
)
parser.add_argument("--visualize", action="store_true")
parser.add_argument("--cpu", action="store_true", help="Run on the CPU instead of the card.")

NUM_CLASSES = 21  # scannet20 + unlabeled


def scene_names(scenes):
    """``--scenes`` as the loader takes it: a split file or a tuple."""
    if scenes is not None and not scenes.endswith(".txt"):
        return tuple(scenes.split(","))
    return scenes


def main(argv=None):
    args = parser.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    dataset = Scannet(
        args.dataset_path, args.seqmeta_path, scene_names(args.scenes),
        start=args.start, end=args.end, height=args.height, width=args.width,
        return_labels=args.fuse_labels,
    )
    sample = dataset[0]
    colors, depths, intrinsics, poses = sample[:4]
    feature_image = None
    if args.fuse_labels:
        labels = sample[-1].numpy()  # (L, H, W, 1) scannet20 ids
        feature_image = torch.from_numpy(
            labels_to_onehot(labels.squeeze(-1), NUM_CLASSES)).to(device)[None]
    frames = RGBDImages(
        colors.to(device)[None], depths.to(device)[None],
        intrinsics.to(device)[None, None], poses.to(device)[None],
        feature_image=feature_image,
    )
    slam = PointFusion(odom=args.odometry,
                       feature_channels=NUM_CLASSES if args.fuse_labels else 0)
    pointclouds, recovered_poses = slam(frames)
    print("map points:", pointclouds.num_points.cpu().numpy())
    if args.fuse_labels:
        n = int(pointclouds.num_points[0])
        fused = pointclouds.features[0, :n, 1:].cpu().numpy()  # skip ccount
        counts = np.bincount(fused.argmax(-1), minlength=NUM_CLASSES)
        names = list(dataset.color_encoding.keys())
        print("fused map class counts:")
        for c in np.argsort(-counts):
            if counts[c]:
                print(f"  {names[c]:>14s}: {counts[c]}")

    if args.visualize:
        show(pointclouds, 0)
    return pointclouds, recovered_poses


if __name__ == "__main__":
    main()
