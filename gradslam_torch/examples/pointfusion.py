r"""PointFusion on a TUM or ICL sequence (PyTorch port).

Counterpart of ``examples/pointfusion.py``, with the same flags and output:
load a batch of short sequences from disk, run PointFusion and print the
map counts and the poses' shape; optionally show the fused map with open3d.
Runs on the card unless ``--cpu`` is given:

    python -m gradslam_torch.examples.pointfusion --dataset tum \
        --dataset_path /data/TUM --odometry gradicp --seqlen 30 \
        --batch_size 1 --height 480 --width 640

``main(argv)`` returns ``(pointclouds, recovered_poses)``.
"""

from __future__ import annotations

import argparse

from gradslam_torch import PointFusion
from gradslam_torch.config import CfgNode
from gradslam_torch.datasets import ICL, TUM
from gradslam_torch.examples._common import batch_frames, show
from gradslam_torch.utils import parse_pyramid

parser = argparse.ArgumentParser()
parser.add_argument(
    "--dataset", type=str, required=True, choices=["tum", "icl"],
    help="Dataset to use.",
)
parser.add_argument(
    "--dataset_path", type=str, required=True, help="Path to the dataset directory."
)
parser.add_argument(
    "--odometry", type=str, default="gradicp", choices=["gt", "icp", "gradicp"],
    help="Odometry method to use.",
)
parser.add_argument("--sequences", type=str, default=None)
parser.add_argument("--seqlen", type=int, default=10)
parser.add_argument("--batch_size", type=int, default=2)
parser.add_argument("--height", type=int, default=120)
parser.add_argument("--width", type=int, default=160)
parser.add_argument("--config", type=str, default=None, help="Optional YAML config.")
parser.add_argument(
    "--quantize-colors", action="store_true",
    help="8-bit colors packed into the map row (geometry and trajectory unchanged).",
)
parser.add_argument(
    "--pyramid", type=str, default=None,
    help="Coarse-to-fine odometry schedule 'ds:iters,ds:iters,...' "
    "(e.g. '8:6,4:4'); coarser levels warm-start finer ones.",
)
parser.add_argument(
    "--robust-loss", type=str, default=None, choices=["huber", "tukey"],
    help="Robust ICP kernel (IRLS).",
)
parser.add_argument("--robust-scale", type=float, default=0.05)
parser.add_argument(
    "--dist-thresh", type=float, default=None,
    help="Squared-distance gate on ICP associations (e.g. 0.01 = 10 cm).",
)
parser.add_argument(
    "--motion-model", type=str, default="static",
    choices=["static", "constant_velocity"],
    help="Odometry initialization across frames.",
)
parser.add_argument(
    "--normal-pitch", type=int, default=None,
    help="Finite-difference baseline (pixels) for normal maps (default: 1, "
    "the reference's).",
)
parser.add_argument(
    "--odom-assoc", type=str, default="knn",
    help="Odometry data association: 'knn' (1-NN every iteration) or "
    "'projective' (project the map into the live camera). With --pyramid, a "
    "comma-separated per-level list, e.g. --pyramid 8:6,8:4 "
    "--odom-assoc projective,knn.",
)
parser.add_argument(
    "--prune-every", type=int, default=0,
    help="Every N mapped frames, drop points whose confidence is below "
    "--prune-min-confidence (0 = off).",
)
parser.add_argument("--prune-min-confidence", type=float, default=1.5)
parser.add_argument(
    "--odom-angle-gate", type=float, default=None,
    help="Normal-compatibility gate (degrees) on odometry associations.",
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
parser.add_argument(
    "--relocalize-below", type=float, default=0.0,
    help="In-scan recovery: relocalize when the tracking-health inlier "
    "fraction drops below this (0 = off).",
)
parser.add_argument(
    "--anchor-every", type=int, default=0,
    help="Freeze a keyframe anchor every N frames and recover slow drift "
    "against it (requires --relocalize-below; 0 = off).",
)
parser.add_argument("--visualize", action="store_true")
parser.add_argument("--cpu", action="store_true", help="Run on the CPU instead of the card.")


def main(argv=None):
    args = parser.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    cfg = CfgNode({
        "odometry": args.odometry,
        "seqlen": args.seqlen,
        "height": args.height,
        "width": args.width,
    })
    if args.config:
        cfg.merge_from_file(args.config)

    # The quantized map layout packs colors assuming [0, 1]; 0-255 dataset
    # floats would clip every channel to white.
    norm = dict(normalize_color=True) if args.quantize_colors else {}
    if args.dataset == "tum":
        dataset = TUM(args.dataset_path, sequences=args.sequences, seqlen=cfg.seqlen,
                      height=cfg.height, width=cfg.width, **norm)
    else:
        dataset = ICL(args.dataset_path, trajectories=args.sequences, seqlen=cfg.seqlen,
                      height=cfg.height, width=cfg.width, **norm)

    samples = [dataset[i] for i in range(min(args.batch_size, len(dataset)))]
    frames = batch_frames(samples, device)
    slam = PointFusion(
        odom=cfg.odometry,
        quantize_colors=args.quantize_colors,
        pyramid=parse_pyramid(args.pyramid),
        robust_loss=args.robust_loss,
        robust_scale=args.robust_scale,
        dist_thresh=args.dist_thresh,
        motion_model=args.motion_model,
        normal_pitch=args.normal_pitch,
        odom_assoc=(args.odom_assoc.split(",") if "," in args.odom_assoc else args.odom_assoc),
        odom_sym_normals=args.odom_sym_normals,
        odom_point_weight=args.odom_point_weight,
        odom_subpixel=args.odom_subpixel,
        odom_angle_gate=args.odom_angle_gate,
        relocalize_below=args.relocalize_below,
        anchor_every=args.anchor_every,
        prune_every=args.prune_every,
        prune_min_confidence=args.prune_min_confidence,
    )
    pointclouds, recovered_poses = slam(frames)
    if args.quantize_colors:
        pointclouds = PointFusion.decode_map(pointclouds)
    print("map points per sequence:", pointclouds.num_points.cpu().numpy())
    print("recovered poses shape:", tuple(recovered_poses.shape))
    dropped = int(pointclouds.num_dropped.sum())
    if dropped:
        print(f"WARNING: map overflowed — {dropped} points dropped (raise map_capacity)")

    if args.visualize:
        show(pointclouds, 0)
    return pointclouds, recovered_poses


if __name__ == "__main__":
    main()
