#!/usr/bin/env python3
r"""Smoke test of the PyTorch / CUDA port (``gradslam_torch``) on one GPU.

Run from the root of a checkout, with no arguments, on a machine with one
NVIDIA H100:

    python3 chip_smoke.py

Phases (each raises on failure; nothing is caught):

1. print the card's name and power limit; require CUDA; turn TF32 off;
2. build the CUDA 1-NN kernel (``gradslam_torch/ops/csrc/knn.cu``) from the
   checkout's sources and print the build time;
3. hold the kernel against its plain PyTorch version on the card (the
   tracked slice's shapes, a ragged masked case with NaN padding, B=2, exact
   ties) and time both with CUDA events;
4. run tracked ``PointFusion(odom='gradicp', dsratio=4, numiters=10)`` on the
   30-frame 640x480 synthetic clip with the six-segment capacity schedule:
   one warm-up run, then timed runs that must launch the kernel exactly
   2 * 10 * 29 = 580 times each, track with ATE <= 1e-4 m, drop no point and
   end with a map within 0.2% of the reference's 516,197 points; a small
   clip must also agree with the CPU run of the same code;
5. run ``odom='gt'`` with the same schedule: map within 0.2% of 516,214;
6. profile one tracked and one gt run with ``torch.profiler``: the
   device's busy share and the kernels that take the most device time;
7. print the kernels' JSON line, the card's line, and the result line.

Exits non-zero, printing no result, when no CUDA device is available.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from gradslam_torch import PointFusion, synthetic_sequence
from gradslam_torch.interop import rgbdimages_from_numpy
from gradslam_torch.odometry.icputils import downsample_rgbdimages
from gradslam_torch.ops import knn_cuda, nn_points
from gradslam_torch.ops._build import load_library
from gradslam_torch.utils.precision import disable_tf32, tf32_disabled

B, L, H, W = 1, 30, 480, 640
DSRATIO, NUMITERS = 4, 10
SCHEDULE = [
    (5, 332_800), (5, 360_448), (5, 399_360),
    (5, 443_392), (5, 486_400), (5, 532_480),
]
# Reference (PyTorch gradslam on CPU) final map sizes on this clip.
REF_COUNT_GRADICP = 516_197
REF_COUNT_GT = 516_214
ATE_BAR_M = 1e-4
KNN_LAUNCHES_PER_RUN = 2 * NUMITERS * (L - 1)
KNN_DIST_ATOL = 1e-5
TIMED_RUNS = 2


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> list:
    """Per-launch times (ms) of ``fn`` over ``iters`` runs, CUDA events."""
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def d2_at(src, tgt, idx) -> torch.Tensor:
    """Squared distance (float32, expanded form, clamped at 0) from each
    source point to the target that ``idx`` names."""
    t = torch.gather(tgt, 1, idx.long()[..., None].expand(-1, -1, 3))
    d2 = (src * src).sum(-1) + (t * t).sum(-1) - 2.0 * (src * t).sum(-1)
    return torch.clamp(d2, min=0.0)


def check_knn_result(name, src, tgt, mask, d_k, i_k) -> float:
    """Holds a kernel result ``(d_k, i_k)`` against the plain version on one
    case; returns max |d_kernel - d_plain|. Every index the kernel returns
    must name a valid target whose distance, worked out from the inputs, is
    the one the kernel reports. Indices may differ from the plain version's
    only at proven ties: the targets both name lie at distances equal within
    1e-6 * max(1, d)."""
    d_p, i_p = nn_points(src, tgt, mask)
    M = tgt.shape[1]
    if not bool(((i_k >= 0) & (i_k < M)).all()):
        raise AssertionError(f"knn {name}: index outside [0, {M})")
    if mask is not None and not bool(torch.gather(mask, 1, i_k.long()).all()):
        raise AssertionError(f"knn {name}: an index names a masked target")
    max_err = float((d_k - d_p).abs().max())
    if not (max_err <= KNN_DIST_ATOL):
        raise AssertionError(f"knn {name}: max |d_kernel - d_plain| = {max_err}")
    d_at_k = d2_at(src, tgt, i_k)
    own_err = float((d_k - d_at_k).abs().max())
    if not (own_err <= KNN_DIST_ATOL):
        raise AssertionError(
            f"knn {name}: reported distance differs from the distance at the "
            f"reported index by {own_err}")
    differ = i_k != i_p
    n_differ = int(differ.sum())
    d_at_p = d2_at(src, tgt, i_p)
    tie_tol = 1e-6 * torch.clamp(d_at_p, min=1.0)
    if bool((differ & ((d_at_k - d_at_p).abs() > tie_tol)).any()):
        raise AssertionError(f"knn {name}: {n_differ} indices differ outside ties")
    log(f"knn {name}: src {tuple(src.shape)} tgt {tuple(tgt.shape)} "
        f"max_abs_err {max_err:.3e}, max |d_kernel - d(src, tgt[idx_kernel])| "
        f"{own_err:.3e}, {n_differ} index differences (all ties)")
    return max_err


def check_knn_case(name, src, tgt, mask) -> float:
    d_k, i_k = knn_cuda.nn_points_cuda(src, tgt, mask)
    return check_knn_result(name, src, tgt, mask, d_k, i_k)


def knn_phase(frames) -> dict:
    dev = frames.device
    # The tracked slice's shapes: the ds-4 frame cloud (N = 19,200) against
    # a map window of capacity 2 * 120 * 160 = 38,400, half of it NaN padding.
    pc0 = downsample_rgbdimages(frames[:, 0], DSRATIO)
    pc1 = downsample_rgbdimages(frames[:, 1].with_poses(frames.poses[:, 0:1]), DSRATIO)
    n0 = pc0.points.shape[1]
    slice_tgt = torch.cat([pc0.points, torch.full_like(pc0.points, float("nan"))], dim=1)
    slice_mask = torch.arange(2 * n0, device=dev)[None] < pc0.num_points[:, None]
    slice_src = pc1.points.contiguous()

    g = torch.Generator(device="cpu").manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=g).to(dev)

    ragged_tgt = randn(1, 3001, 3)
    ragged_mask = (torch.rand(1, 3001, generator=g) < 0.5).to(dev)
    ragged_tgt[~ragged_mask] = float("nan")
    base = randn(2, 500, 3)
    tie_tgt = base.repeat(1, 4, 1)  # every target appears 4 times
    tie_src = torch.cat([randn(2, 300, 3), base[:, :200]], dim=1)  # some exact hits
    cases = [
        ("slice", slice_src, slice_tgt.contiguous(), slice_mask),
        ("ragged_masked_nan", randn(1, 1001, 3), ragged_tgt, ragged_mask),
        ("batched_B2", randn(2, 777, 3), randn(2, 2049, 3), None),
        ("exact_ties", tie_src, tie_tgt.contiguous(), None),
    ]
    max_err = max(check_knn_case(*c) for c in cases)
    _, tie_idx = knn_cuda.nn_points_cuda(tie_src, tie_tgt.contiguous())
    if not bool((tie_idx < 500).all()):
        raise AssertionError("knn exact_ties: a duplicate target won over its first copy")

    # Time kernel and plain version in turns at the slice's shapes.
    def kernel():
        knn_cuda.nn_points_cuda(slice_src, slice_tgt, slice_mask)

    def plain():
        nn_points(slice_src, slice_tgt, slice_mask)

    for fn in (kernel, plain):
        fn()
    torch.cuda.synchronize()
    t_plain, t_kernel = [], []
    for fn, acc in ((plain, t_plain), (kernel, t_kernel), (kernel, t_kernel), (plain, t_plain)):
        acc.extend(cuda_ms(fn, 10))
    ms, plain_ms = float(np.median(t_kernel)), float(np.median(t_plain))
    log(f"knn timing at N={slice_src.shape[1]} M={slice_tgt.shape[1]}: "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (median of 20, CUDA events)")
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms}


def ate_m(poses: np.ndarray, gt: np.ndarray) -> float:
    """Translation RMSE (m) of ``(L, 4, 4)`` poses against ground truth,
    without alignment (the tracker starts at the ground-truth pose)."""
    err = poses[:, :3, 3].astype(np.float64) - gt[:, :3, 3].astype(np.float64)
    return float(np.sqrt(np.mean(np.sum(err**2, axis=-1))))


def check_map(pc, poses, ref_count: int, tag: str) -> int:
    n = int(pc.num_points[0])
    dropped = int(pc.num_dropped[0])
    if dropped != 0:
        raise AssertionError(f"{tag}: {dropped} points dropped")
    if abs(n - ref_count) > 0.002 * ref_count:
        raise AssertionError(f"{tag}: map count {n} not within 0.2% of {ref_count}")
    for name in ("points", "normals", "colors", "features"):
        if not bool(torch.isfinite(getattr(pc, name)[0, :n]).all()):
            raise AssertionError(f"{tag}: non-finite map {name}")
    if tuple(poses.shape) != (B, L, 4, 4) or not bool(torch.isfinite(poses).all()):
        raise AssertionError(f"{tag}: bad poses {tuple(poses.shape)}")
    return n


def timed_runs(slam, frames, expect_launches: int, tag: str):
    """Warm-up run, then ``TIMED_RUNS`` timed runs; each timed run must
    launch the kernel ``expect_launches`` times. Returns the last result,
    the mean seconds per run, the peak memory and the launch count."""
    slam(frames)
    torch.cuda.synchronize()
    secs = []
    for _ in range(TIMED_RUNS):
        torch.cuda.reset_peak_memory_stats()
        knn_cuda.launches = 0
        t0 = time.perf_counter()
        pc, poses = slam(frames)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        launches = knn_cuda.launches
        if launches != expect_launches:
            raise AssertionError(f"{tag}: {launches} kernel launches, expected {expect_launches}")
    peak = torch.cuda.max_memory_allocated()
    return pc, poses, float(np.mean(secs)), peak, launches


def small_clip_agrees_with_cpu() -> None:
    """The same tracked code on a small clip, on the card (kernel) and on
    the CPU (plain version): poses within 1e-4, counts within 0.2%."""
    rgb, depth, K, P = synthetic_sequence(1, 6, 96, 128, seed=1)
    out = {}
    for dev in ("cuda", "cpu"):
        frames = rgbdimages_from_numpy(rgb, depth, K, P, device=dev)
        pc, poses = PointFusion(odom="gradicp", dsratio=DSRATIO, numiters=NUMITERS)(frames)
        out[dev] = (int(pc.num_points[0]), poses.cpu().numpy())
    dpose = float(np.abs(out["cuda"][1] - out["cpu"][1]).max())
    nc, nh = out["cuda"][0], out["cpu"][0]
    if not (dpose <= 1e-4 and abs(nc - nh) <= 0.002 * nh):
        raise AssertionError(f"small clip: card vs CPU |dpose| {dpose}, counts {nc} vs {nh}")
    log(f"small clip 96x128x6: card vs CPU max |dpose| {dpose:.3e}, counts {nc} vs {nh}")


def profile_run(slam, frames, tag: str, unprofiled_s: float) -> None:
    """One run under ``torch.profiler``: prints the wall time, the device's
    busy time, its share of this run's wall time and of ``unprofiled_s``
    (the mean wall time of this process's unprofiled runs of the same
    pipeline), and the kernels that take the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        slam(frames)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    # Device-side events only (kernels, copies, memsets): on one stream they
    # do not overlap, so their sum is the time the device was busy.
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in device)
    busy = busy_us / 1e6
    log(f"profile {tag}: wall {wall:.4f} s, device busy {busy:.4f} s "
        f"({100 * busy / wall:.1f}% of this profiled run; "
        f"{100 * busy / unprofiled_s:.1f}% of the unprofiled mean {unprofiled_s:.4f} s "
        f"in this process), {sum(e.count for e in device)} device events")
    top = sorted(device, key=lambda e: e.self_device_time_total, reverse=True)[:15]
    for e in top:
        log(f"  {e.self_device_time_total / 1e3:10.3f} ms  {e.count:6d}x  {e.key[:90]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    disable_tf32()
    if not tf32_disabled():
        raise AssertionError("TF32 is still enabled")

    t0 = time.perf_counter()
    load_library()
    log(f"kernel build + load: {time.perf_counter() - t0:.2f} s")

    rgb, depth, K, P = synthetic_sequence(B, L, H, W, seed=0)
    frames = rgbdimages_from_numpy(rgb, depth, K, P, device="cuda")
    knn = knn_phase(frames)

    small_clip_agrees_with_cpu()

    tracked = PointFusion(odom="gradicp", dsratio=DSRATIO, numiters=NUMITERS,
                          map_capacity=SCHEDULE)
    pc, poses, secs, peak, launches = timed_runs(
        tracked, frames, KNN_LAUNCHES_PER_RUN, "gradicp")
    count = check_map(pc, poses, REF_COUNT_GRADICP, "gradicp")
    ate = ate_m(poses[0].cpu().numpy(), P[0])
    if not ate <= ATE_BAR_M:
        raise AssertionError(f"gradicp: ATE {ate} m above {ATE_BAR_M} m")
    log(f"PointFusion(gradicp) {H}x{W}x{L}: {L / secs:.4f} frames/s "
        f"({secs:.4f} s/run, mean of {TIMED_RUNS}), ATE {ate:.4e} m, "
        f"map {count} points, 0 dropped, knn launches {launches}/run, "
        f"peak memory {peak} B")

    gt = PointFusion(odom="gt", map_capacity=SCHEDULE)
    pc_gt, poses_gt, secs_gt, peak_gt, _ = timed_runs(gt, frames, 0, "gt")
    count_gt = check_map(pc_gt, poses_gt, REF_COUNT_GT, "gt")
    log(f"PointFusion(gt) {H}x{W}x{L}: {L / secs_gt:.4f} frames/s "
        f"({secs_gt:.4f} s/run), map {count_gt} points, 0 dropped, "
        f"peak memory {peak_gt} B")

    profile_run(tracked, frames, "gradicp", secs)
    profile_run(gt, frames, "gt", secs_gt)

    print(json.dumps({"kernels": [{
        "name": "knn1_cuda",
        "route": "cuda",
        "source": "gradslam_torch/ops/csrc/knn.cu",
        "replaces": "gradslam_tpu/ops/knn_pallas.py:41",
        "launches": launches,
        "max_abs_err": knn["max_abs_err"],
        "ms": knn["ms"],
        "plain_ms": knn["plain_ms"],
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
