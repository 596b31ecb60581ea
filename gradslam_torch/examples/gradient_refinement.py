r"""Gradient-based sensor refinement through the SLAM pipeline (PyTorch).

Counterpart of ``examples/gradient_refinement.py``. The fused map and the
recovered trajectory are differentiable functions of the raw sensor inputs,
so upstream quantities (a wrong depth scale, a wrong focal length, a
per-pixel depth bias) can be recovered by gradient descent through the whole
``PointFusion`` run.

A synthetic RGB-D clip is corrupted (depths scaled by ``--depth-scale-error``,
focal length by ``--focal-error``); correction parameters start at the
identity, the corrected frames run through PointFusion, and a loss on the
pipeline's output is minimized with Adam (gradients clipped to a global norm
of 1, the step size halved every ``steps // 3`` steps):

- ``--loss chamfer`` (default): squared chamfer distance between the fused
  map and a reference map built from the true sensor model;
- ``--loss ate``: mean squared position error against the reference
  trajectory, which needs tracked odometry (``--odometry gradicp``): the
  gradients then flow through every ICP solve.

``--optimize depth`` recovers a dense per-pixel depth residual instead of
the two calibration scalars. Runs on the card unless ``--cpu`` is given:

    python -m gradslam_torch.examples.gradient_refinement --steps 40
    python -m gradslam_torch.examples.gradient_refinement --loss ate \
        --odometry gradicp --steps 25 --lr 0.03
    python -m gradslam_torch.examples.gradient_refinement --optimize depth --steps 30

Prints the loss trajectory and the recovered corrections (1.0 is a perfect
recovery of the calibration).
"""

from __future__ import annotations

import argparse
import math

import torch

from gradslam_torch import PointFusion, RGBDImages, synthetic_sequence
from gradslam_torch.metrics import chamfer_distance

parser = argparse.ArgumentParser(
    description="Recover sensor miscalibration by gradient descent through SLAM."
)
parser.add_argument("--height", type=int, default=32)
parser.add_argument("--width", type=int, default=40)
parser.add_argument("--seqlen", type=int, default=4)
parser.add_argument("--steps", type=int, default=40, help="Adam steps.")
parser.add_argument("--lr", type=float, default=0.05)
parser.add_argument("--depth-scale-error", type=float, default=1.08,
                    help="Injected multiplicative depth corruption (1.0 = none).")
parser.add_argument("--focal-error", type=float, default=0.94,
                    help="Injected multiplicative focal-length corruption (1.0 = none).")
parser.add_argument("--loss", type=str, default="chamfer", choices=["chamfer", "ate"],
                    help="Map quality (chamfer against a reference map) or trajectory "
                    "error (against reference poses; needs tracked odometry).")
parser.add_argument("--optimize", type=str, default="calibration",
                    choices=["calibration", "depth"],
                    help="Two calibration scalars (depth scale and focal) or a dense "
                    "per-pixel depth-residual field.")
parser.add_argument("--odometry", type=str, default="gt", choices=["gt", "icp", "gradicp"])
parser.add_argument("--cpu", action="store_true", help="Run on the CPU instead of the card.")


def refine(
    H=32,
    W=40,
    L=4,
    steps=40,
    lr=0.05,
    depth_scale_error=1.08,
    focal_error=0.94,
    loss="chamfer",
    odometry="gt",
    optimize="calibration",
    verbose=True,
    device="cuda",
):
    """Run the refinement on ``device``.

    ``optimize='calibration'``: returns ``(losses, recovered_depth_scale,
    recovered_focal_scale)``, "recovered" meaning correction x corruption
    (1.0 is perfect recovery).

    ``optimize='depth'``: a smooth multiplicative bias field corrupts the
    depths and a dense per-pixel residual is optimized through the
    pipeline; returns ``(losses, depth_mae_before, depth_mae_after)`` in
    metres."""
    if loss == "ate" and odometry == "gt":
        raise ValueError(
            "--loss ate needs tracked odometry (icp/gradicp): with odom='gt' "
            "the output poses ARE the reference poses, so the trajectory "
            "loss is identically zero and nothing is recovered."
        )
    rgb, depths, intrinsics, poses = (
        torch.from_numpy(a).to(device) for a in synthetic_sequence(1, L, H, W, seed=3))
    # few solver iterations track the gentle synthetic motion and keep the
    # backward cheap
    slam = PointFusion(odom=odometry, dsratio=1, numiters=3, map_capacity=L * H * W)

    # The reference outputs: map and trajectory from the true sensor model
    # (in practice a survey scan or a calibration rig's trajectory).
    with torch.no_grad():
        ref_map, ref_poses = slam(RGBDImages(rgb, depths, intrinsics, poses))
    ref_pts, ref_mask = ref_map.points, ref_map.nonpad_mask
    ref_traj = ref_poses[..., :3, 3]

    if optimize == "calibration":
        focal = torch.zeros(4, 4, dtype=torch.bool, device=device)
        focal[0, 0] = focal[1, 1] = True
        depths_obs = depths * depth_scale_error
        K_obs = torch.where(focal, intrinsics * focal_error, intrinsics)
        params = {"log_depth_scale": torch.zeros((), device=device, requires_grad=True),
                  "log_focal_scale": torch.zeros((), device=device, requires_grad=True)}

        def apply_correction():
            depth = depths_obs * torch.exp(params["log_depth_scale"])
            K = torch.where(focal, K_obs * torch.exp(params["log_focal_scale"]), K_obs)
            return RGBDImages(rgb, depth, K, poses)
    else:
        # a smooth multiplicative bias (a warped-lens-style systematic
        # depth error that a per-pixel field can undo, unlike noise)
        yy, xx = torch.meshgrid(
            torch.arange(H, dtype=torch.float32, device=device),
            torch.arange(W, dtype=torch.float32, device=device), indexing="ij")
        bias = 1.0 + 0.03 * torch.sin(4 * math.pi * xx / W) * torch.cos(3 * math.pi * yy / H) + 0.01
        depths_obs = depths * bias[None, None, :, :, None]
        params = {"depth_residual": torch.zeros_like(depths, requires_grad=True)}

        def apply_correction():
            return RGBDImages(rgb, depths_obs + params["depth_residual"], intrinsics, poses)

    def loss_fn():
        pc, out_poses = slam(apply_correction())
        if loss == "chamfer":
            # squared: the euclidean chamfer's sqrt has an infinite gradient
            # at 0, where a converging calibration drives every distance
            return torch.mean(chamfer_distance(
                pc.points, ref_pts, mask_a=pc.nonpad_mask, mask_b=ref_mask, squared=True))
        # differentiable, alignment-free trajectory loss
        return torch.mean(torch.sum((out_poses[..., :3, 3] - ref_traj) ** 2, dim=-1))

    # The loss is steep far from the true calibration and nearly flat at
    # it: a fixed step oscillates once close, three half-lives settle it.
    opt = torch.optim.Adam(list(params.values()), lr=lr)
    half_life = max(1, steps // 3)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda step: 0.5 ** (step / half_life))

    def correction(name):
        return float(torch.exp(params[name].detach()))

    def describe():
        if optimize == "calibration":
            return (f"depth-scale corr {correction('log_depth_scale'):.4f}  "
                    f"focal corr {correction('log_focal_scale'):.4f}")
        return f"depth MAE {depth_mae() * 1000:.2f} mm"

    def depth_mae():
        with torch.no_grad():
            return float(torch.mean(torch.abs(depths_obs + params["depth_residual"] - depths)))

    losses = []
    for i in range(steps):
        opt.zero_grad()
        value = loss_fn()
        value.backward()
        torch.nn.utils.clip_grad_norm_(list(params.values()), 1.0)
        opt.step()
        sched.step()
        losses.append(float(value.detach()))
        if verbose and (i % max(1, steps // 10) == 0 or i == steps - 1):
            print(f"step {i:3d}  loss {losses[-1]:.3e}  " + describe())

    if optimize == "calibration":
        rec_depth = correction("log_depth_scale") * depth_scale_error
        rec_focal = correction("log_focal_scale") * focal_error
        if verbose:
            print(f"\nrecovered sensor model (1.0 = perfect): "
                  f"depth scale {rec_depth:.4f}, focal {rec_focal:.4f}")
            print(f"loss: {losses[0]:.3e} -> {losses[-1]:.3e}")
        return losses, rec_depth, rec_focal
    mae_before = float(torch.mean(torch.abs(depths_obs - depths)))
    mae_after = depth_mae()
    if verbose:
        print(f"\ndense depth refinement: MAE {mae_before * 1000:.2f} mm -> "
              f"{mae_after * 1000:.2f} mm; loss {losses[0]:.3e} -> {losses[-1]:.3e}")
    return losses, mae_before, mae_after


def main(argv=None):
    args = parser.parse_args(argv)
    refine(
        H=args.height,
        W=args.width,
        L=args.seqlen,
        steps=args.steps,
        # the depth field's step is in metres: 50 mm a step overshoots a
        # ~45 mm bias, 10 mm is right (override with --lr)
        lr=0.01 if args.optimize == "depth" and args.lr == 0.05 else args.lr,
        depth_scale_error=args.depth_scale_error,
        focal_error=args.focal_error,
        loss=args.loss,
        odometry=args.odometry,
        optimize=args.optimize,
        device="cpu" if args.cpu else "cuda",
    )


if __name__ == "__main__":
    main()
