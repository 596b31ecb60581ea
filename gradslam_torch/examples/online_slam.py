r"""Online (streaming) SLAM on a TUM sequence with checkpoint and resume, and
map and trajectory export (PyTorch port).

Counterpart of ``examples/online_slam.py``, with the same flags and output.
It drives the frame-at-a-time API the way an online system would:

- one ``step`` per incoming frame (or, with ``--relocalize-below``,
  ``localize`` -> tracking-health gate -> optional ``relocalize`` ->
  ``map_update``);
- the SLAM state (map buffers and trajectory) is saved every
  ``--checkpoint-every`` frames (:func:`gradslam_torch.utils.save_state`);
- ``--resume`` restarts from the checkpoint in ``--out`` and continues
  mid-sequence;
- the final map is written as ``map.ply`` (``Pointclouds.save_ply``) and
  the trajectory and ground truth in TUM format (``trajectory.txt``,
  ``groundtruth.txt``).

Runs on the card unless ``--cpu`` is given:

    python -m gradslam_torch.examples.online_slam --dataset_path /data/TUM \
        --odometry gradicp --seqlen 20 --checkpoint-every 5 --out run1

``main(argv)`` returns ``(pointclouds, trajectory (L, 4, 4))``.
"""

from __future__ import annotations

import argparse
import os

import torch

from gradslam_torch import ICPSLAM, PointFusion, RGBDImages
from gradslam_torch.datasets import TUM
from gradslam_torch.geometry import compose_transformations, inverse_transformation
from gradslam_torch.slam import (
    perturbation_grid,
    prune_map,
    relocalize,
    tracking_health,
    voxel_downsample,
)
from gradslam_torch.utils import parse_pyramid
from gradslam_torch.utils.checkpoint import load_state, save_state
from gradslam_torch.utils.trajectory_io import save_trajectory_tum

parser = argparse.ArgumentParser()
parser.add_argument("--dataset_path", type=str, required=True)
parser.add_argument("--sequences", type=str, default=None)
parser.add_argument("--pipeline", type=str, default="pointfusion",
                    choices=["pointfusion", "icpslam"])
parser.add_argument("--odometry", type=str, default="gradicp", choices=["gt", "icp", "gradicp"])
parser.add_argument("--seqlen", type=int, default=10)
parser.add_argument("--height", type=int, default=120)
parser.add_argument("--width", type=int, default=160)
parser.add_argument("--map_capacity", type=int, default=None)
parser.add_argument(
    "--pyramid", type=str, default=None,
    help="Coarse-to-fine odometry 'ds:iters,ds:iters,...' (e.g. '8:6,4:4').",
)
parser.add_argument(
    "--robust-loss", type=str, default=None, choices=["huber", "tukey"],
    help="Robust IRLS kernel for the point-to-plane solve.",
)
parser.add_argument("--robust-scale", type=float, default=0.05)
parser.add_argument(
    "--dist-thresh", type=float, default=None,
    help="Squared-distance association gate for the solve and for "
    "--health-every telemetry.",
)
parser.add_argument(
    "--odom-assoc", type=str, default="knn", choices=["knn", "projective"],
    help="Odometry data association: 'knn' or 'projective'. The "
    "--health-every telemetry follows the same association.",
)
parser.add_argument(
    "--odom-angle-gate", type=float, default=None,
    help="Normal-compatibility gate (degrees) on odometry associations.",
)
parser.add_argument(
    "--motion-model", type=str, default="static", choices=["static", "constant_velocity"],
    help="odometry initialization: zero-motion (default) or the "
    "constant-velocity prior (threads the previous relative transform "
    "into each step)")
parser.add_argument(
    "--export-voxel-size", type=float, default=None,
    help="If set, voxel-grid decimate the map (voxel edge in meters) "
    "before writing map.ply.",
)
parser.add_argument("--prune-every", type=int, default=0,
                    help="prune unstable map points every N frames (0 = never)")
parser.add_argument("--prune-min-confidence", type=float, default=1.0)
parser.add_argument("--health-every", type=int, default=0,
                    help="Every N frames, print tracking-health telemetry "
                    "(inlier fraction / residual / map overlap).")
parser.add_argument("--relocalize-below", type=float, default=0.0,
                    help="Decompose each tracked step into localize -> "
                    "health gate -> fuse; when the solved pose's inlier "
                    "fraction drops below this threshold, relocalize over "
                    "a hypothesis grid BEFORE fusing (0 = off).")
parser.add_argument("--checkpoint-every", type=int, default=0,
                    help="save SLAM state every N frames (0 = never)")
parser.add_argument("--resume", action="store_true",
                    help="continue from the checkpoint in --out")
parser.add_argument("--out", type=str, default="/tmp/online_slam",
                    help="output directory (checkpoint, map.ply, trajectory.txt)")
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
parser.add_argument("--cpu", action="store_true", help="Run on the CPU instead of the card.")


def main(argv=None):
    args = parser.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    if args.prune_every and args.pipeline != "pointfusion":
        parser.error("--prune-every requires --pipeline pointfusion "
                     "(the aggregate map has no confidence channel)")
    os.makedirs(args.out, exist_ok=True)
    ckpt_path = os.path.join(args.out, "state.npz")

    dataset = TUM(args.dataset_path, sequences=args.sequences, seqlen=args.seqlen,
                  height=args.height, width=args.width)
    colors, depths, intrinsics, poses, *_ = dataset[0]
    colors = colors.to(device)[None]  # (1, L, H, W, 3)
    depths = depths.to(device)[None]
    intrinsics = intrinsics.to(device)[None, None]  # (1, 1, 4, 4)
    gt_poses = poses.to(device)[None]  # (1, L, 4, 4)
    L = colors.shape[1]

    cls = PointFusion if args.pipeline == "pointfusion" else ICPSLAM
    capacity = args.map_capacity or L * args.height * args.width
    slam = cls(odom=args.odometry, odom_assoc=args.odom_assoc,
               odom_sym_normals=args.odom_sym_normals,
               odom_point_weight=args.odom_point_weight,
               odom_subpixel=args.odom_subpixel,
               odom_angle_gate=args.odom_angle_gate,
               map_capacity=capacity, pyramid=parse_pyramid(args.pyramid),
               robust_loss=args.robust_loss, robust_scale=args.robust_scale,
               dist_thresh=args.dist_thresh)

    start = 0
    traj = []
    if args.resume and os.path.exists(ckpt_path):
        pc, est = load_state(ckpt_path, device=device)
        if pc.capacity < capacity:
            # Resuming with a longer --seqlen than the original run: grow the
            # checkpointed buffers to the configured capacity, or the
            # fixed-capacity map would overflow.
            print(f"growing map capacity {pc.capacity} -> {capacity}")
            pc = pc.with_capacity(capacity)
        traj = list(est)
        start = len(traj)
        print(f"resumed from {ckpt_path} at frame {start} "
              f"({int(pc.num_points[0])} map points)")
    else:
        pc = slam.empty_map(1, capacity, device=device)

    def frame(s, pose):
        return RGBDImages(colors[:, s:s + 1], depths[:, s:s + 1], intrinsics, pose)

    def motion(new_pose, prev_pose):
        """The world-frame motion ``new @ inv(prev)``, the constant-velocity
        prior of the next step."""
        return compose_transformations(new_pose, inverse_transformation(prev_pose))

    prev = None
    if start > 0:
        prev = frame(start - 1, traj[-1][None, None])
    # constant-velocity prior: the previous step's relative transform,
    # threaded through the stateless step API
    cv = args.motion_model == "constant_velocity"
    prev_transform = None
    if cv and len(traj) >= 2:
        # resumed run: re-derive the prior from the checkpointed trajectory
        # so the first resumed step matches an uninterrupted run
        prev_transform = motion(traj[-1][None], traj[-2][None])

    for s in range(start, L):
        if args.odometry == "gt" or prev is None:
            live = frame(s, gt_poses[:, s:s + 1])
            pc, new_pose = slam.step(pc, live)
        elif args.relocalize_below:
            # decomposed serving loop: localize -> health gate ->
            # (relocalize) -> fuse. step() fuses unconditionally, so a
            # diverged solve would corrupt the map before the gate sees it.
            live = frame(s, None)
            new_pose = slam.localize(pc, live, prev, prev_transform=prev_transform)
            h = tracking_health(pc, live.with_poses(new_pose),
                                robust_scale=args.robust_scale,
                                dist_thresh=args.dist_thresh,
                                method=args.odom_assoc)
            inl = float(h["inlier_frac"][0])
            if inl < args.relocalize_below:
                anchors = torch.cat([
                    perturbation_grid(
                        new_pose[:, 0],
                        yaw_deg=(0.0, -15.0, 15.0, -30.0, 30.0),
                        translations=((0, 0, 0), (-0.2, 0, 0), (0.2, 0, 0)),
                    ),
                    perturbation_grid(prev.poses[:, 0], yaw_deg=(0.0, -15.0, 15.0)),
                ], dim=1)
                # same association gate (dist_thresh) as the health check
                # above, so the winner's inlier_frac is comparable with the
                # threshold it will be judged against
                new_pose, info = relocalize(
                    pc, live, anchors, dsratio=slam.dsratio,
                    robust_scale=args.robust_scale, dist_thresh=args.dist_thresh,
                )
                print(f"  relocalized (inliers {inl:.2f} -> "
                      f"{float(info['inlier_frac'][0]):.2f}, hypothesis "
                      f"{int(info['best_hypothesis'][0])}/{anchors.shape[1]})")
            pc = slam.map_update(pc, live.with_poses(new_pose))
            if cv:
                prev_transform = motion(new_pose[:, 0], prev.poses[:, 0])
        else:
            live = frame(s, None)
            pc, new_pose = slam.step(pc, live, prev, prev_transform=prev_transform)
            if cv:
                prev_transform = motion(new_pose[:, 0], prev.poses[:, 0])
        traj.append(new_pose[0, 0])
        prev = frame(s, new_pose)
        if args.prune_every and (s + 1) % args.prune_every == 0:
            pc = prune_map(pc, args.prune_min_confidence)
        print(f"frame {s}: {int(pc.num_points[0])} map points")
        if args.health_every and (s + 1) % args.health_every == 0:
            h = tracking_health(pc, frame(s, new_pose), robust_scale=args.robust_scale,
                                dist_thresh=args.dist_thresh, method=args.odom_assoc)
            print(
                f"  health: inliers {float(h['inlier_frac'][0]):.2f} "
                f"assoc {float(h['assoc_frac'][0]):.2f} "
                f"median|r| {float(h['median_abs_residual'][0]):.4f} m "
                f"overlap {float(h['overlap_frac'][0]):.2f}"
            )
        if args.checkpoint_every and (s + 1) % args.checkpoint_every == 0:
            save_state(ckpt_path, pc, torch.stack(traj))
            print(f"  checkpointed -> {ckpt_path}")

    est = torch.stack(traj)  # (L, 4, 4)
    save_state(ckpt_path, pc, est)
    export = pc
    if args.export_voxel_size:
        export = voxel_downsample(pc, args.export_voxel_size)
        print(f"voxel decimation @ {args.export_voxel_size} m: "
              f"{int(pc.num_points[0])} -> {int(export.num_points[0])} points")
    ply_path = os.path.join(args.out, "map.ply")
    # TUM loads colors as 0-255 floats (normalize_color=False), so the fused
    # map's colors are 0-255 too: without color_range='byte' the float
    # [0, 1] convention would clip every vertex to white.
    export.save_ply(ply_path, index=0, color_range="byte")
    traj_path = os.path.join(args.out, "trajectory.txt")
    save_trajectory_tum(traj_path, est)
    gt_path = os.path.join(args.out, "groundtruth.txt")
    save_trajectory_tum(gt_path, gt_poses[0])
    print(f"map: {int(export.num_points[0])} points -> {ply_path}")
    print(f"trajectory ({L} poses) -> {traj_path}")
    print(f"evaluate: python scripts/evaluate_traj.py {gt_path} {traj_path}")
    return pc, est


if __name__ == "__main__":
    main()
