r"""ICPSLAM on a ScanNet scene sequence (PyTorch port).

Counterpart of ``examples/icpslam_scannet.py``, with the same flags and
output: load a scene sequence, run ICPSLAM, print the map count and the
Umeyama-aligned ATE against the ground truth. Runs on the card unless
``--cpu`` is given:

    python -m gradslam_torch.examples.icpslam_scannet \
        --dataset_path /data/scannet/scans --seqmeta_path /data/scannet/seqmeta

``main(argv)`` returns ``(pointclouds, recovered_poses)``.
"""

from __future__ import annotations

import argparse

from gradslam_torch import ICPSLAM, RGBDImages
from gradslam_torch.datasets import Scannet
from gradslam_torch.examples._common import show
from gradslam_torch.examples.pointfusion_scannet import scene_names
from gradslam_torch.metrics import ate_rmse

parser = argparse.ArgumentParser()
parser.add_argument("--dataset_path", type=str, required=True)
parser.add_argument("--seqmeta_path", type=str, required=True)
parser.add_argument("--scenes", type=str, default=None)
parser.add_argument("--odometry", type=str, default="gradicp", choices=["gt", "icp", "gradicp"])
parser.add_argument("--start", type=int, default=0)
parser.add_argument("--end", type=int, default=4)
parser.add_argument("--height", type=int, default=240)
parser.add_argument("--width", type=int, default=320)
parser.add_argument("--visualize", action="store_true")
parser.add_argument("--cpu", action="store_true", help="Run on the CPU instead of the card.")


def main(argv=None):
    args = parser.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    dataset = Scannet(
        args.dataset_path, args.seqmeta_path, scene_names(args.scenes),
        start=args.start, end=args.end, height=args.height, width=args.width,
        return_labels=False,
    )
    colors, depths, intrinsics, poses, *_ = dataset[0]
    poses = poses.to(device)
    frames = RGBDImages(colors.to(device)[None], depths.to(device)[None],
                        intrinsics.to(device)[None, None], poses[None])
    slam = ICPSLAM(odom=args.odometry)
    pointclouds, recovered_poses = slam(frames)
    print("map points:", pointclouds.num_points.cpu().numpy())
    print("ATE-RMSE vs GT:", float(ate_rmse(recovered_poses[0], poses)))

    if args.visualize:
        show(pointclouds, 0)
    return pointclouds, recovered_poses


if __name__ == "__main__":
    main()
