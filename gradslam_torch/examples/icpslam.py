r"""ICPSLAM on a TUM or ICL sequence (PyTorch port).

Counterpart of ``examples/icpslam.py``, with the same flags and output:
load sequences from disk, run ICPSLAM and report the trajectory error
against the ground truth (Umeyama-aligned ATE). Runs on the card unless
``--cpu`` is given:

    python -m gradslam_torch.examples.icpslam --dataset icl \
        --dataset_path /data/ICL --odometry icp --seqlen 30 --batch_size 1 \
        --height 240 --width 320

``main(argv)`` returns ``(pointclouds, recovered_poses)``.
"""

from __future__ import annotations

import argparse

from gradslam_torch import ICPSLAM
from gradslam_torch.datasets import ICL, TUM
from gradslam_torch.examples._common import batch_frames, show
from gradslam_torch.metrics import ate_rmse

parser = argparse.ArgumentParser()
parser.add_argument("--dataset", type=str, required=True, choices=["tum", "icl"])
parser.add_argument("--dataset_path", type=str, required=True)
parser.add_argument("--odometry", type=str, default="gradicp", choices=["gt", "icp", "gradicp"])
parser.add_argument("--sequences", type=str, default=None)
parser.add_argument("--seqlen", type=int, default=10)
parser.add_argument("--batch_size", type=int, default=2)
parser.add_argument("--height", type=int, default=120)
parser.add_argument("--width", type=int, default=160)
parser.add_argument(
    "--icp-window-frames", type=int, default=None,
    help="Associate odometry against only the most recent K frames' worth "
    "of map rows (default: the whole map).",
)
parser.add_argument(
    "--odom-assoc", type=str, default="knn", choices=["knn", "projective"],
    help="Odometry data association: 'knn' or 'projective'.",
)
parser.add_argument(
    "--odom-sym-normals", action="store_true",
    help="Symmetric point-to-plane normals for the projective solver.",
)
parser.add_argument(
    "--odom-point-weight", type=float, default=0.0,
    help="Weight of point-to-point rows in the projective solver (0 = off).",
)
parser.add_argument(
    "--odom-subpixel", action="store_true",
    help="Bilinear (sub-pixel) projective association (projective association only).",
)
parser.add_argument("--visualize", action="store_true")
parser.add_argument("--cpu", action="store_true", help="Run on the CPU instead of the card.")


def main(argv=None):
    args = parser.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    if args.dataset == "tum":
        dataset = TUM(args.dataset_path, sequences=args.sequences, seqlen=args.seqlen,
                      height=args.height, width=args.width)
    else:
        dataset = ICL(args.dataset_path, trajectories=args.sequences, seqlen=args.seqlen,
                      height=args.height, width=args.width)
    samples = [dataset[i] for i in range(min(args.batch_size, len(dataset)))]
    frames = batch_frames(samples, device)
    slam = ICPSLAM(odom=args.odometry, odom_assoc=args.odom_assoc,
                   odom_sym_normals=args.odom_sym_normals,
                   odom_point_weight=args.odom_point_weight,
                   odom_subpixel=args.odom_subpixel,
                   icp_window_frames=args.icp_window_frames)
    pointclouds, recovered_poses = slam(frames)
    print("map points per sequence:", pointclouds.num_points.cpu().numpy())
    for b in range(len(samples)):
        err = ate_rmse(recovered_poses[b], frames.poses[b])
        print(f"sequence {b}: ATE-RMSE vs GT = {float(err):.6f} m")

    if args.visualize:
        show(pointclouds, 0)
    return pointclouds, recovered_poses


if __name__ == "__main__":
    main()
