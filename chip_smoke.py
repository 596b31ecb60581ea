#!/usr/bin/env python3
r"""Smoke test of the PyTorch / CUDA port (``gradslam_torch``) on one GPU.

Run from the root of a checkout, with no arguments, on a machine with one
NVIDIA H100:

    python3 chip_smoke.py

Phases (each raises on failure; nothing is caught):

1. print the card's name and power limit; require CUDA; turn TF32 off;
2. build the CUDA kernels (``gradslam_torch/ops/csrc/knn.cu``, the 1-NN
   search, and ``scatter.cu``, the unique-row scatter; one ``nvcc`` each, in
   parallel) from the checkout's sources and print the build time;
3. hold the 1-NN kernel against its plain PyTorch version on the card at
   the paths' three shapes (the tracked slice's N=19,200/M=38,400, the
   production recipe's 1-NN level N=4,800/M=9,600, ICPSLAM window+pyramid's
   ds-8 level N=1,200/M=2,400) and on cases that stress the target splits
   (a ragged masked case with NaN padding, B=2, exact ties with the copies
   of a target in different splits, B=2 with one row all masked, M=0, fewer
   targets than splits, N=1, N not a multiple of a block's 512 sources);
   every case must give the same bits with 1, the plan's and forced split
   counts; time kernel and plain version as device time behind a spin
   kernel, the kernel also as one call with its launch and at other split
   counts, beside its bound and issue floor;
3b. hold the scatter kernel against its plain version on the card, bit for
   bit as integer views (the TPU microbenchmark's shape, fusion's int64
   winner table, a C=3 append into a 2.3M-row buffer, B=2, ICPSLAM flat's
   map window over the 2.3M-row map, fusion's row inversion into 1,228,800
   rows, every row dropped; and edge cases: 4-, 8- and 12-byte tails after
   the fill's 16-byte words, NaN, -0.0 and infinite fills, NaN payloads
   copied, B=3 with M=0, size=0, C=8 and C=10 float32 rows, an int32 dest,
   buffers and values that are not 16-byte aligned), its gradient against
   the plain version's, one call captured in a CUDA graph and replayed; time
   kernel, plain version, the library call (``torch.full`` + ``index_put_``)
   and an empty kernel (the launch floor) at the microbenchmark's and the
   paths' five shapes, with the kernel's host time a call;
4. run tracked ``PointFusion(odom='gradicp', dsratio=4, numiters=10)`` on the
   30-frame 640x480 synthetic clip with the six-segment capacity schedule:
   one warm-up run, then timed runs that must launch the 1-NN kernel exactly
   2 * 10 * 29 = 580 times each and the scatter kernel exactly 205 times,
   track with ATE <= 1e-4 m, drop no point and end with a map within 0.2%
   of the reference's 516,197 points; a small clip must also agree with the
   CPU run of the same code;
5. run ``odom='gt'`` with the same schedule: map within 0.2% of 516,214;
6. profile one tracked and one gt run with ``torch.profiler``: the
   device's busy share and the kernels that take the most device time;
7. run the production hard-clip recipe (hybrid projective + 1-NN pyramid,
   robust gates, constant velocity, windowed fusion, quantized colors,
   prune every 4 frames) on the 30-frame 640x480 hard clip: one warm-up and
   two timed runs that must launch the kernel exactly 4 * 29 = 116 times
   each, drop no point, track with an aligned ATE <= 0.025 m and end with a
   map within 1% of the JAX package's CPU run
   (``tests/port/data/hard_production_640x480_jax_cpu.npz``);
8. run the same recipe at 160x120 on a 9-frame hard clip on the card and on
   the CPU: each frame's step from the CPU run's state within 2e-4; the two
   whole runs apart by at most 1e-4 on frame 1 and 5e-3 on any frame, with
   map counts within 0.2%;
9. run the JAX package's headline, ``odom='gt'`` with quantized colors and
   the six-segment schedule: the same map count as phase 5's float-color
   map, points within 1e-6 of it;
10. profile one production run with ``torch.profiler``;
11. run the ICPSLAM slice (``scripts/bench_all.py:223-246``) on the 30-frame
    320x240 synthetic clip with its six-segment schedule: flat
    ``odom='icp'``, the 2-frame recency window, window + pyramid, and
    ``odom='gt'``; for each one warm-up and two timed runs with exact launch
    counts of both kernels, the aggregate map at exactly 30 * 320 * 240 =
    2,304,000 points with 0 dropped, finite poses, and an aligned ATE within
    twice the JAX package's CPU run of the same configuration
    (``tests/port/data/icpslam_320x240_jax_cpu.npz``); then profile one flat
    run;
12. print the kernels' JSON line, the card's line, and the result line.

Every timed run counts both kernels' launches from 0 and must hit the
counts derived from the code (``KNN_LAUNCHES_PER_RUN``,
``PROD_LAUNCHES_PER_RUN``, ``ICP_KNN_LAUNCHES``, ``SCATTER_LAUNCHES``); the
kernels' line prints the counts read in the runs.

Exits non-zero, printing no result, when no CUDA device is available.
"""

from __future__ import annotations

import dataclasses
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from gradslam_torch import ICPSLAM, PointFusion, RGBDImages, hard_sequence, synthetic_sequence
from gradslam_torch.geometry import (
    compose_transformations,
    inverse_transformation,
    orthonormalize_rotations,
)
from gradslam_torch.interop import rgbdimages_from_numpy
from gradslam_torch.metrics import ate_rmse
from gradslam_torch.odometry.icputils import downsample_rgbdimages
from gradslam_torch.ops import _build, knn_cuda, nn_points, scatter_cuda
from gradslam_torch.ops._build import load_library
from gradslam_torch.ops.scatter import scatter_rows_into_plain, scatter_rows_plain
from gradslam_torch.structures.pointclouds import scatter_rows, scatter_rows_into
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

# The production hard-clip recipe (scripts/bench_all.py:606-612) and the
# JAX package's CPU run of it on hard_sequence(1, 30, 480, 640).
PRODUCTION = dict(
    odom="gradicp", pyramid=[(8, 6), (8, 4)],
    odom_assoc=["projective", "knn"], odom_sym_normals=True,
    odom_angle_gate=45.0, map_capacity=1_228_800,
    prune_every=4, prune_min_confidence=1.5,
    quantize_colors=True, lookahead_assoc="reuse",
    motion_model="constant_velocity", robust_loss="tukey",
    robust_scale=0.03, dist_thresh=0.01, normal_pitch=4,
)
GOLDEN = Path(__file__).resolve().parent / "tests/port/data/hard_production_640x480_jax_cpu.npz"
PROD_LAUNCHES_PER_RUN = PRODUCTION["pyramid"][1][1] * (L - 1)  # one search an iteration
PROD_ATE_BAR_M = 0.025
PROD_COUNT_REL = 0.01
# The same recipe at 160x120 (pyramid strides and normal pitch scaled by 1/4).
SMALL = dict(PRODUCTION, pyramid=[(2, 6), (2, 4)], normal_pitch=1, map_capacity=4 * 120 * 160)
SMALL_L, SMALL_H, SMALL_W = 9, 120, 160

# The ICPSLAM slice (scripts/bench_all.py:223-246) at 320x240 and the JAX
# package's CPU runs of it (tests/port/make_icpslam_golden.py).
ICP_H, ICP_W = 240, 320
ICP_SCHEDULE = [(5, (i + 1) * 5 * ICP_H * ICP_W) for i in range(6)]
ICPSLAM_CONFIGS = {
    "flat": dict(odom="icp", dsratio=4, numiters=10),
    "window": dict(odom="icp", dsratio=4, numiters=10, icp_window_frames=2),
    "window_pyramid": dict(odom="icp", pyramid=[(8, 8), (4, 3)], icp_window_frames=2),
    "gt": dict(odom="gt"),
}
ICP_GOLDEN = Path(__file__).resolve().parent / "tests/port/data/icpslam_320x240_jax_cpu.npz"
ICP_MAP_COUNT = L * ICP_H * ICP_W  # every depth of the clip is valid
ICP_ATE_FACTOR = 2.0  # bar: aligned ATE <= 2x the JAX CPU golden's
# 1-NN launches: two searches an LM iteration ('fresh' lookahead).
ICP_KNN_LAUNCHES = {"flat": 2 * 10 * (L - 1), "window": 2 * 10 * (L - 1),
                    "window_pyramid": 2 * (8 + 3) * (L - 1), "gt": 0}

# Scatter launches a run, counted from the code. One count is one wrapper
# call that launches scatter_kernel (behind its fill or copy of the table):
# one compact_masked, one fusion table, or one aggregate append of one buffer:
# - a 1-NN level: the frame's downsample (points, normals, colors: 3) and,
#   without a nested pyramid, the map window (points, normals: 2);
# - a nested pyramid: one compaction at the finest stride and one for each
#   coarser level, and 3 a 1-NN level for the frame;
# - PointFusion fusion: sort_full + gather 2 (winner table, row inversion),
#   windowed + gather 3 (window, winner table, row inversion); prune 1;
# - ICPSLAM's aggregate map: 3 a frame (points, normals, colors).
PROD_PRUNES = sum(1 for g in range(L) if (g + 1) % PRODUCTION["prune_every"] == 0)
SCATTER_LAUNCHES = {
    "tracked_easy": 2 + (L - 1) * (2 + 3 + 2),
    "gt_easy": 2 * L,
    "production_hard": 3 + (L - 1) * ((1 + 3) + 3) + PROD_PRUNES,
    "gt_quantized_easy": 2 * L,
    "icpslam_flat": 3 + (L - 1) * ((2 + 3) + 3),
    "icpslam_window": 3 + (L - 1) * ((2 + 3) + 3),
    "icpslam_window_pyramid": 3 + (L - 1) * ((1 + 1 + 2 * 3) + 3),
    "icpslam_gt": 3 * L,
}
LAUNCHES = {}  # path -> its last timed run's {"knn": n, "scatter": n}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
FP32_FLOPS_PER_S = 67e12  # float32 outside the tensor cores


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


def device_ms(fn, iters: int) -> float:
    """Device time (ms) a call of ``fn``, from CUDA events around ``iters``
    back-to-back calls queued behind a ~10 ms spin kernel: the host enqueues
    them all while the device spins, so the events time the device's work
    and not the host's launch overhead."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


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
    1e-6 * max(1, d). A source with no valid target must get (1e30, 0), as
    from the plain version."""
    d_p, i_p = nn_points(src, tgt, mask)
    none = d_p == 1e30  # finite sources: only where no target is valid
    if not (torch.equal(none, d_k == 1e30) and bool((i_k[none] == 0).all())
            and bool((i_p[none] == 0).all())):
        raise AssertionError(f"knn {name}: a source with no valid target is not (1e30, 0)")
    if bool(none.all()):
        log(f"knn {name}: src {tuple(src.shape)} tgt {tuple(tgt.shape)}: no valid target, "
            f"(1e30, 0) everywhere as from the plain version")
        return 0.0
    if bool(none.any()):  # check the other rows
        keep = ~none.all(dim=1)
        src, tgt, d_p, i_p, d_k, i_k = (t[keep] for t in (src, tgt, d_p, i_p, d_k, i_k))
        mask = None if mask is None else mask[keep]
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


def check_knn_case(name, src, tgt, mask, splits=(7, 64)) -> float:
    """One case: the kernel against the plain version, and the kernel's
    result bit for bit the same with the targets in one split, in the plan's
    splits and in each of ``splits``."""
    d_k, i_k = knn_cuda.nn_points_cuda(src, tgt, mask)
    err = check_knn_result(name, src, tgt, mask, d_k, i_k)
    for s in (1, None, *splits):
        d_s, i_s = knn_cuda.nn_points_cuda(src, tgt, mask, splits=s)
        if not (torch.equal(d_s, d_k) and torch.equal(i_s, i_k)):
            raise AssertionError(f"knn {name}: splits={s} differs from the default call")
    return err


def time_knn(src, tgt, mask, sms: int, clock_hz: float) -> dict:
    """Device time a call (``device_ms``: medians of 6 rounds of 20 calls,
    kernel and plain version in turns) of the kernel and of the plain
    version; the kernel's time a single call with its launch (``cuda_ms``,
    median of 20); its device time at other split counts (one round each);
    the bound and the issue floor."""
    B, N, M = src.shape[0], src.shape[1], tgt.shape[1]
    plan = knn_cuda.split_plan_for(B, N, M, src.device)
    fns = {"kernel": lambda: knn_cuda.nn_points_cuda(src, tgt, mask),
           "plain": lambda: nn_points(src, tgt, mask)}
    for fn in fns.values():
        fn()
    acc = {k: [] for k in fns}
    for _ in range(3):
        for key in ("plain", "kernel", "kernel", "plain"):
            acc[key].append(device_ms(fns[key], 20))
    row = {"N": N, "M": M, "splits": plan[0], "per_split": plan[1],
           "ms": float(np.median(acc["kernel"])), "plain_ms": float(np.median(acc["plain"])),
           "call_ms": float(np.median(cuda_ms(fns["kernel"], 20)))}
    row["bound_ms"], row["bound_by"] = knn_bound(N, M, B)
    row["issue_floor_ms"] = knn_issue_floor(N, M, B, sms, clock_hz)
    row["share"] = row["bound_ms"] / row["ms"]
    sweep = sorted({1, 2, 4, 8, 16, 24, 32, 48, 64, max(1, plan[0] // 2), plan[0], 2 * plan[0]})
    row["splits_ms"] = {
        s: device_ms(lambda s=s: knn_cuda.nn_points_cuda(src, tgt, mask, splits=s), 20)
        for s in sweep}
    log(f"knn timing at N={N} M={M}: device time a call: kernel {row['ms']:.4f} ms "
        f"(S={plan[0]} splits of {plan[1]}), plain {row['plain_ms']:.4f} ms; bound "
        f"{row['bound_ms']:.4f} ms ({row['bound_by']}), share {100 * row['share']:.1f}%, "
        f"issue floor {row['issue_floor_ms']:.4f} ms; a single kernel call with its launch "
        f"{row['call_ms']:.4f} ms; by split count: "
        + ", ".join(f"S={s} {t:.4f}" for s, t in row["splits_ms"].items()))
    return row


def padded_window(pc):
    """A frame cloud as a map window: twice its rows, the second half NaN
    padding behind the mask."""
    n = pc.points.shape[1]
    tgt = torch.cat([pc.points, torch.full_like(pc.points, float("nan"))], dim=1).contiguous()
    mask = torch.arange(2 * n, device=tgt.device)[None] < pc.num_points[:, None]
    return tgt, mask


def level_pair(frames, ds: int) -> tuple:
    """A 1-NN level's inputs: frame 1's stride-``ds`` cloud (at frame 0's
    pose) against frame 0's as a map window of twice its rows, half NaN
    padding."""
    pc0 = downsample_rgbdimages(frames[:, 0], ds)
    pc1 = downsample_rgbdimages(frames[:, 1].with_poses(frames.poses[:, 0:1]), ds)
    tgt, mask = padded_window(pc0)
    return pc1.points.contiguous(), tgt, mask


def knn_phase(frames, hard, icp_frames) -> dict:
    dev = frames.device
    # The three shapes of the paths: the tracked slice (the ds-4 frame cloud,
    # N = 19,200, against a map window of capacity 2 * 120 * 160 = 38,400);
    # the production recipe's 1-NN level, which is also ICPSLAM
    # window+pyramid's ds-4 level (N = 4,800, M = 9,600); ICPSLAM
    # window+pyramid's ds-8 level on the 320x240 clip (N = 1,200, M = 2,400).
    levels = {"tracked": level_pair(frames, DSRATIO),
              "production_level": level_pair(hard, PRODUCTION["pyramid"][1][0]),
              "window_pyramid_ds8": level_pair(icp_frames, ICPSLAM_CONFIGS["window_pyramid"]
                                               ["pyramid"][0][0])}

    g = torch.Generator(device="cpu").manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=g).to(dev)

    ragged_tgt = randn(1, 3001, 3)
    ragged_mask = (torch.rand(1, 3001, generator=g) < 0.5).to(dev)
    ragged_tgt[~ragged_mask] = float("nan")
    base = randn(2, 500, 3)
    tie_tgt = base.repeat(1, 4, 1).contiguous()  # every target appears 4 times
    tie_src = torch.cat([randn(2, 300, 3), base[:, :200]], dim=1)  # some exact hits
    # B=2 with different masks; batch row 1 has no valid target at all
    two_mask = torch.stack([torch.rand(700, generator=g) < 0.3, torch.zeros(700, dtype=torch.bool)])
    two_tgt = randn(2, 700, 3)
    two_tgt[~two_mask.to(dev)] = float("nan")
    # N = 513 and 777 are not multiples of the 512 sources of a search
    # block; M = 100 is 4 chunks, fewer than the 7 and 64 splits forced
    cases = {
        **levels,
        "ragged_masked_nan": (randn(1, 1001, 3), ragged_tgt, ragged_mask),
        "batched_B2": (randn(2, 777, 3), randn(2, 2049, 3), None),
        "exact_ties": (tie_src, tie_tgt, None),
        # each source on a target with three twins within 1e-7 in later
        # splits: the partial minima round near 0, some below it
        "near_duplicates": (base[:1, :300], torch.cat(
            [base[:1] + 3e-8 * k * randn(1, 500, 3) for k in range(4)], dim=1), None),
        "B2_masks_one_all_masked": (randn(2, 513, 3), two_tgt, two_mask.to(dev)),
        "M0": (randn(1, 300, 3), randn(1, 0, 3), None),
        "M_below_S": (randn(1, 1030, 3), randn(1, 100, 3), None),
        "N1": (randn(1, 1, 3), randn(1, 4000, 3), None),
    }
    max_err = max(check_knn_case(name, *c) for name, c in cases.items())
    # the four copies of a target lie in different splits (7 splits of 288
    # rows, and the plan's); every split count gave these bits: the first
    # copy wins
    _, tie_idx = knn_cuda.nn_points_cuda(tie_src, tie_tgt)
    if not bool((tie_idx < 500).all()) or not torch.equal(
            tie_idx[:, 300:].long(), torch.arange(200, device=dev).expand(2, -1)):
        raise AssertionError("knn exact_ties: a duplicate won over its first copy")
    log("knn split checks: ties across split boundaries go to the first copy; sources with no "
        "valid target get (1e30, 0); every case bit-identical across split counts")

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clock_hz = max_sm_clock_hz()
    shapes = [time_knn(*pair, sms, clock_hz) for pair in levels.values()]
    return {"max_abs_err": max_err, "shapes": shapes, "sm_clock_hz": clock_hz}


def max_sm_clock_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    )
    return 1e6 * float(out.stdout.strip().splitlines()[0])


def knn_bound(N: int, M: int, nb: int = 1) -> tuple:
    """Least time (ms) of a masked 1-NN at one shape, and what sets it:
    8 float32 flops a (source, target) pair (the cross term's multiply and
    two FMAs, 1 + 2 * 2; the distance's add and FMA, 1 + 2) at the card's
    67 TFLOP/s, which counts an FMA as two flops, against reading the
    clouds and the mask once and writing distances and indices once."""
    t_ops = 8.0 * nb * N * M / FP32_FLOPS_PER_S
    t_bytes = nb * (12.0 * N + 13.0 * M + 8.0 * N) / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def knn_issue_floor(N: int, M: int, nb: int, sms: int, clock_hz: float) -> float:
    """Least time (ms) an exact version of the arithmetic can issue in: 6
    lane instructions a pair (FMUL, FFMA, FFMA, FADD, FFMA and one min),
    each SM issuing 128 lanes a clock (4 schedulers of 32)."""
    return 1e3 * 6.0 * nb * N * M / (sms * 128 * clock_hz)


# The TPU kernel's shape (scripts/microbench_scatter.py:41-42).
SCRIPT_N, SCRIPT_HW = 655_360, 307_200


def scatter_cases(dev) -> list:
    """``(name, table, dest, values, fill)`` cases of the scatter kernel.
    ``table`` is the new table's row count or, for a write into a buffer,
    the buffer itself. Inputs are made from a numpy seed."""
    rng = np.random.RandomState(0)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    # scripts/microbench_scatter.py:make_inputs(seed=0): a permutation
    # prefix of unique int32 indices; indices >= HW are dropped
    idx = rng.permutation(max(SCRIPT_N, SCRIPT_HW))[:SCRIPT_N].astype(np.int32)
    val = rng.rand(SCRIPT_N).astype(np.float32)
    # fusion's winner table at 640x480: each of the largest tracked
    # capacity's 532,480 rows wins a unique pixel or is dropped (-1); the
    # table holds int64 map rows and "no winner" = the capacity
    cap = SCHEDULE[-1][1]
    perm = rng.permutation(cap)
    win_dest = np.where(perm < H * W, perm, -1)[None].astype(np.int64)
    # ICPSLAM's last append: 76,800 C=3 rows after 29 frames into the
    # 2,304,000-row buffer, a tenth of the pixels invalid
    hw = ICP_H * ICP_W
    mask = rng.rand(1, hw) > 0.1
    app_dest = np.where(mask, (L - 1) * hw + np.cumsum(mask, axis=1) - 1, -1).astype(np.int64)
    # B=2 compaction with overflow (the map window: 153,600 rows into 9,600)
    cmask = rng.rand(2, 2 * hw) < 0.3
    c_dest = np.where(cmask, np.cumsum(cmask, axis=1) - 1, -1).astype(np.int64)
    # ICPSLAM flat's map-window compaction (odometry/icputils.py:411-414):
    # the whole 2,304,000-row map, the rows on the ds-4 pixel grid (about
    # one in 16) ranked into the 2 * 60 * 80 = 9,600-row window
    wmask = rng.rand(1, ICP_MAP_COUNT) < 1 / 16
    w_dest = np.where(wmask, np.cumsum(wmask, axis=1) - 1, -1).astype(np.int64)
    # fusion's row inversion at the production capacity
    # (slam/fusionutils.py:340): each of the 640x480 pixels names a unique
    # map row of 1,228,800 (a tenth of them none); the table holds int64
    # pixel ids and "no pixel" = HW
    inv_dest = rng.permutation(PRODUCTION["map_capacity"])[:H * W].astype(np.int64)
    inv_dest[rng.rand(H * W) < 0.1] = -1
    return [
        ("microbench_f32", SCRIPT_HW, t(idx[None]), t(val[None]), 0.0),
        ("winner_table_i64", H * W, t(win_dest), t(np.arange(cap, dtype=np.int64)[None]), cap),
        ("append_2.3M_C3", t(rng.randn(1, ICP_MAP_COUNT, 3).astype(np.float32)), t(app_dest),
         t(rng.randn(1, hw, 3).astype(np.float32)), None),
        ("compact_B2_C3", 2 * 60 * 80, t(c_dest), t(rng.randn(2, 2 * hw, 3).astype(np.float32)),
         0.0),
        ("map_window_2.3M_C3", 2 * 60 * 80, t(w_dest),
         t(rng.randn(1, ICP_MAP_COUNT, 3).astype(np.float32)), 0.0),
        ("row_inversion_1.2M_i64", PRODUCTION["map_capacity"], t(inv_dest[None]),
         t(np.arange(H * W, dtype=np.int64)[None]), H * W),
        ("all_dropped_i32", 1000, t(np.full((1, 5000), -1, np.int64)),
         t(rng.randint(0, 9, (1, 5000, 2)).astype(np.int32)), 7),
    ]


SCATTER_TIMED = 6  # the first six cases are the timed shapes


def scatter_edge_cases(dev) -> list:
    """Cases, in the form of :func:`scatter_cases`, that stress the word
    widths and the partition of the fill or copy: tables whose bytes leave
    a 4-, 8- and 12-byte tail after the 16-byte words, NaN and -0.0 fills,
    B=3 with M=0, size=0, C=8 and C=10 float32 rows (16- and 8-byte words),
    an int32 dest with negative and past-the-end entries, and a buffer and
    values that are not 16-byte aligned (element words only). Inputs are
    made from a numpy seed."""
    rng = np.random.RandomState(1)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    def dest(B, M, size, drop=0.2, dtype=np.int64):
        d = np.stack([rng.permutation(size + M)[:M] for _ in range(B)])
        d[rng.rand(B, M) < drop] = -1
        return t(d.astype(dtype))

    def f32(*shape):
        return t(rng.randn(*shape).astype(np.float32))

    # a buffer with NaN payloads and -0.0, copied bit for bit
    nan_buf = rng.randn(1, 1001, 3).astype(np.float32)
    nan_buf.view(np.uint32)[0, :50, 0] = 0x7FC00000 + np.arange(50)  # distinct NaNs
    nan_buf[0, 50:60] = -0.0
    # 4-byte-aligned but not 16-byte-aligned views (a contiguous tail)
    odd_buf = torch.cat([f32(1), f32(1001 * 3)])[1:].view(1, 1001, 3)
    odd_vals = torch.cat([f32(1), f32(700 * 4)])[1:].view(1, 700, 4)
    i32_dest = rng.randint(-400, 1300, (2, 3000)).astype(np.int32)
    for b in range(2):  # unique inside the table: keep a value's first copy
        _, first = np.unique(i32_dest[b], return_index=True)
        dup = np.ones(3000, bool)
        dup[first] = False
        i32_dest[b, dup] = -1
    return [
        ("tail_4B_nan_fill", 1001, dest(1, 1500, 1001), f32(1, 1500), float("nan")),
        ("tail_8B_neg0_fill", 1001, dest(1, 900, 1001), f32(1, 900, 2), -0.0),
        ("tail_12B_C3", 1001, dest(1, 2000, 1001), f32(1, 2000, 3), 1.5),
        ("tail_8B_i64", 1001, dest(1, 1200, 1001), t(rng.randint(-9, 9, (1, 1200), np.int64)),
         -1),
        ("copy_nan_buffer", t(nan_buf), dest(1, 800, 1001), f32(1, 800, 3), None),
        ("B3_M0", 100, t(np.zeros((3, 0), np.int64)), f32(3, 0, 3), 2.0),
        ("size0", 0, dest(2, 50, 0), f32(2, 50, 3), 0.0),
        ("C8_f32", 9_600, dest(1, 20_000, 9_600, 0.5), f32(1, 20_000, 8), 0.0),
        ("C10_f32", 9_600, dest(1, 20_000, 9_600, 0.5), f32(1, 20_000, 10), float("-inf")),
        ("i32_dest_B2", 1000, t(i32_dest), f32(2, 3000, 3), float("nan")),
        ("unaligned_copy", odd_buf, dest(1, 700, 1001), f32(1, 700, 3), None),
        ("unaligned_values", 1001, dest(1, 700, 1001), odd_vals, float("inf")),
    ]


def int_view(x: torch.Tensor) -> torch.Tensor:
    """The bits of a float32/int32/int64 tensor as integers: NaN and -0.0
    compare bit for bit."""
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def scatter_kernel(table, dest, values, fill):
    if isinstance(table, int):
        return scatter_cuda.scatter_rows_cuda(table, dest, values, fill)
    return scatter_cuda.scatter_rows_into_cuda(table, dest, values)


def scatter_plain(table, dest, values, fill):
    if isinstance(table, int):
        return scatter_rows_plain(table, dest, values, fill)
    return scatter_rows_into_plain(table, dest, values)


def scatter_library(table, dest, values, fill):
    """The library call on the same function: ``torch.full`` (or a copy of
    the buffer) and ``index_put_`` of the rows that land in the table (the
    rows are picked before the timing; ``index_put_`` takes no dropped
    rows)."""
    size = table if isinstance(table, int) else table.shape[1]
    keep = (dest >= 0) & (dest < size)
    bidx = torch.arange(dest.shape[0], device=dest.device)[:, None].expand_as(dest)[keep]
    d, v = dest[keep].long(), values[keep]

    def run():
        if isinstance(table, int):
            out = torch.full((dest.shape[0], size) + tuple(values.shape[2:]), fill,
                             dtype=values.dtype, device=values.device)
        else:
            out = table.clone()
        return out.index_put_((bidx, d), v)

    return run


def scatter_bound(table, dest, values) -> float:
    """Least time (ms) of the bytes the function must move: read dest once,
    read the values of the rows that land in the table (a dropped row's
    values are never needed), write the table once and, for a write into a
    buffer, read the buffer rows that no value overwrites."""
    size = table if isinstance(table, int) else table.shape[1]
    row_bytes = math.prod(values.shape[2:]) * values.element_size()
    kept = int(((dest >= 0) & (dest < size)).sum())
    rows = dest.shape[0] * size
    nbytes = dest.numel() * dest.element_size() + (kept + rows) * row_bytes
    if not isinstance(table, int):
        nbytes += (rows - kept) * row_bytes
    return 1e3 * nbytes / HBM_BYTES_PER_S


def host_us(fn, calls: int = 100) -> float:
    """Host time (us) a call of ``fn``: ``time.perf_counter()`` around
    ``calls`` calls enqueued behind a spin kernel of 200M cycles (at least
    0.1 s at the H100's 1,980 MHz), over ``calls``. The calls must take
    under 50 ms (checked): then the device was still spinning and the launch
    queue never filled, so this is the caller's own cost (validation,
    allocation, the launches) without the device's."""
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    secs = time.perf_counter() - t0
    torch.cuda.synchronize()
    if secs >= 0.050:
        raise AssertionError(f"host_us: {calls} calls took {secs:.4f} s, as long as the spin")
    return 1e6 * secs / calls


def kernel_split_ms(fn, calls: int = 10) -> dict:
    """Device time a call of each device kernel ``fn`` launches, from
    ``torch.profiler`` over ``calls`` back-to-back calls; kernels that
    overlap (a dependent launch) count in full each."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {kernel_name(e.key): e.self_device_time_total / 1e3 / calls
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA}


def kernel_name(key: str) -> str:
    """A profiler key without its return type, namespace and arguments:
    ``scatter_rows<unsigned int, int>``, ``Memcpy DtoD``."""
    found = re.search(r"(\w+(?:<[^()]*>)?)\(", key)
    return found.group(1) if found else key.split("(")[0].strip()


def time_scatter(name, table, dest, values, fill) -> dict:
    """One timed shape: device time a call (``device_ms``, medians of 2
    rounds of 10 calls of kernel, plain version, library call and an empty
    kernel, ``torch.cuda._sleep(0)``, the launch floor, taken in turns); the
    kernel's device kernels one by one (``kernel_split_ms``); its host time a
    call (``host_us``, median and least of 7 rounds) and its time as a
    single call with its launch (``cuda_ms``, median of 20); the bound."""
    fns = {"kernel": lambda: scatter_kernel(table, dest, values, fill),
           "plain": lambda: scatter_plain(table, dest, values, fill),
           "library": scatter_library(table, dest, values, fill),
           "floor": lambda: torch.cuda._sleep(0)}
    for fn in fns.values():
        fn()
    acc = {k: [] for k in fns}
    for _ in range(2):
        for key in ("plain", "kernel", "library", "floor", "floor", "library", "kernel", "plain"):
            acc[key].append(device_ms(fns[key], 10))
    row = {"case": name, "ms": float(np.median(acc["kernel"])),
           "plain_ms": float(np.median(acc["plain"])),
           "library_ms": float(np.median(acc["library"])),
           "floor_ms": float(np.median(acc["floor"])),
           "bound_ms": scatter_bound(table, dest, values),
           "kernels_ms": kernel_split_ms(fns["kernel"]),
           "call_ms": float(np.median(cuda_ms(fns["kernel"], 20)))}
    host = [host_us(fns["kernel"]) for _ in range(7)]
    row["host_us"], row["host_us_min"] = float(np.median(host)), float(min(host))
    row["share"] = row["bound_ms"] / row["ms"]
    log(f"scatter timing {name}: device time a call: kernel {row['ms']:.4f} ms ("
        + ", ".join(f"{k} {v:.4f}" for k, v in row["kernels_ms"].items())
        + f"), plain {row['plain_ms']:.4f} ms, library {row['library_ms']:.4f} ms, empty "
        f"kernel {row['floor_ms']:.4f} ms; bound {row['bound_ms']:.4f} ms (bytes), share "
        f"{100 * row['share']:.1f}%; host {row['host_us']:.2f} us a call (least "
        f"{row['host_us_min']:.2f}); a single kernel call with its launch "
        f"{row['call_ms']:.4f} ms")
    return row


def scatter_graph_check(name, table, dest, values, fill) -> None:
    """One call captured in a CUDA graph and replayed: the replay rewrites
    the whole output (set to all-ones bits first) with the eager call's
    bits, and a replay after new values are copied into the captured input
    gives the eager result of the new values."""
    dest, values = dest.clone(), values.clone()
    table = table if isinstance(table, int) else table.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the default stream, as for capture
        scatter_kernel(table, dest, values, fill)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = scatter_kernel(table, dest, values, fill)
    for step in ("capture", "new values"):
        if step == "new values":
            values.copy_(torch.flip(values, dims=[1]))
        int_view(out).fill_(-1)
        graph.replay()
        torch.cuda.synchronize()
        if not torch.equal(int_view(out), int_view(scatter_kernel(table, dest, values, fill))):
            raise AssertionError(f"scatter graph {name}: replay ({step}) differs from the eager call")
    log(f"scatter graph {name}: one captured call, replayed twice (the second on new values), "
        "gives the eager call's bits")


def scatter_phase() -> dict:
    dev = torch.device("cuda")
    cases = scatter_cases(dev)
    max_err = 0.0
    for name, table, dest, values, fill in cases + scatter_edge_cases(dev):
        k = scatter_kernel(table, dest, values, fill)
        torch.cuda.synchronize()
        pl = scatter_plain(table, dest, values, fill)
        if (k.shape != pl.shape or k.dtype != pl.dtype or not k.is_contiguous()
                or not torch.equal(int_view(k), int_view(pl))):
            raise AssertionError(f"scatter {name}: kernel differs from the plain version")
        if k.numel():
            max_err = max(max_err, float((k.double() - pl.double()).nan_to_num(0.0).abs().max()))
        log(f"scatter {name}: table {tuple(k.shape)} {k.dtype}, dest {tuple(dest.shape)} "
            f"{dest.dtype}, bit-equal to the plain version (integer views)")
    # all-dropped: the table is the fill and nothing else
    if not bool((scatter_kernel(*cases[-1][1:]) == cases[-1][4]).all()):
        raise AssertionError("scatter all_dropped: a dropped row was written")
    for case in (cases[0], cases[2]):  # the fill form and the copy form
        scatter_graph_check(*case)

    # gradients of the float scatters, through the dispatchers' autograd
    # Function (kernel forward, gather backward) against the plain version's
    # autograd (index_put's backward)
    for name, table, dest, values, fill in (cases[0], cases[2]):
        w = torch.randn(scatter_plain(table, dest, values, fill).shape, device=dev)
        grads = []
        for route in ("kernel", "plain"):
            v = values.clone().requires_grad_()
            b = None if isinstance(table, int) else table.clone().requires_grad_()
            if route == "kernel":
                out = (scatter_rows(table, dest, v, fill) if b is None
                       else scatter_rows_into(b, dest, v))
            else:
                out = (scatter_rows_plain(table, dest, v, fill) if b is None
                       else scatter_rows_into_plain(b, dest, v))
            (out * w).sum().backward()
            grads.append((v.grad, None if b is None else b.grad))
        (gv_k, gb_k), (gv_p, gb_p) = grads
        if not torch.equal(gv_k, gv_p) or (gb_k is not None and not torch.equal(gb_k, gb_p)):
            raise AssertionError(f"scatter {name}: gradient differs from the plain version's")
        log(f"scatter {name}: gradients bit-equal to the plain version's")

    shapes = [time_scatter(*case) for case in cases[:SCATTER_TIMED]]
    return {"max_abs_err": max_err, "shapes": shapes}


def icpslam_phase() -> tuple:
    """The ICPSLAM slice at 320x240x30 against the JAX package's CPU runs.
    Returns the frames and, for each configuration, the pipeline, the mean
    seconds a run and the 1-NN launch count."""
    golden = np.load(ICP_GOLDEN)
    rgb, depth, K, P = synthetic_sequence(B, L, ICP_H, ICP_W, seed=0)
    frames = rgbdimages_from_numpy(rgb, depth, K, P, device="cuda")
    out = {}
    for name, kw in ICPSLAM_CONFIGS.items():
        slam = ICPSLAM(map_capacity=ICP_SCHEDULE, **kw)
        path = f"icpslam_{name}"
        pc, poses, secs, peak = timed_runs(slam, frames, path, ICP_KNN_LAUNCHES[name])
        count = check_map(pc, poses, ICP_MAP_COUNT, f"icpslam {name}", rel=0.0)
        if int(golden[f"{name}_num_points"]) != count:
            raise AssertionError(f"icpslam {name}: map {count}, JAX golden "
                                 f"{int(golden[f'{name}_num_points'])}")
        est = poses[0].cpu()
        gap = np.linalg.norm(est.numpy()[:, :3, 3] - golden[f"{name}_poses"][:, :3, 3], axis=-1)
        if name == "gt":
            if not torch.equal(est, torch.from_numpy(P[0])):
                raise AssertionError("icpslam gt: poses are not the clip's")
            quality = "poses = the clip's"
        else:
            ate = float(ate_rmse(est, torch.from_numpy(P[0])))
            bar = ICP_ATE_FACTOR * float(golden[f"{name}_ate_m"])
            if not ate <= bar:
                raise AssertionError(f"icpslam {name}: aligned ATE {ate} m above {bar} m")
            quality = (f"aligned ATE {ate:.4e} m (bar {bar:.4e} m, JAX CPU golden "
                       f"{float(golden[f'{name}_ate_m']):.4e} m), unaligned "
                       f"{ate_m(est.numpy(), P[0]):.4e} m")
        log(f"ICPSLAM({name}) {ICP_H}x{ICP_W}x{L}: {L / secs:.4f} frames/s ({secs:.4f} s/run, "
            f"mean of {TIMED_RUNS}), {quality}, map {count} points, 0 dropped, launches a run "
            f"{LAUNCHES[path]}, peak memory {peak} B, max translation gap to the golden "
            f"{gap.max():.4e} m at frame {int(gap.argmax())}")
        out[name] = (slam, secs)
    return frames, out


def ate_m(poses: np.ndarray, gt: np.ndarray) -> float:
    """Translation RMSE (m) of ``(L, 4, 4)`` poses against ground truth,
    without alignment (the tracker starts at the ground-truth pose)."""
    err = poses[:, :3, 3].astype(np.float64) - gt[:, :3, 3].astype(np.float64)
    return float(np.sqrt(np.mean(np.sum(err**2, axis=-1))))


def check_map(pc, poses, ref_count: int, tag: str, rel: float = 0.002) -> int:
    n = int(pc.num_points[0])
    dropped = int(pc.num_dropped[0])
    if dropped != 0:
        raise AssertionError(f"{tag}: {dropped} points dropped")
    if abs(n - ref_count) > rel * ref_count:
        raise AssertionError(f"{tag}: map count {n} not within {100 * rel:g}% of {ref_count}")
    for name in ("points", "normals", "colors", "features"):
        buf = getattr(pc, name)
        if buf is not None and not bool(torch.isfinite(buf[0, :n]).all()):
            raise AssertionError(f"{tag}: non-finite map {name}")
    if tuple(poses.shape) != (B, L, 4, 4) or not bool(torch.isfinite(poses).all()):
        raise AssertionError(f"{tag}: bad poses {tuple(poses.shape)}")
    return n


def timed_runs(slam, frames, path: str, expect_knn: int):
    """Warm-up run, then ``TIMED_RUNS`` timed runs of the path ``path``; each
    timed run must launch the 1-NN kernel ``expect_knn`` times and the
    scatter kernel ``SCATTER_LAUNCHES[path]`` times (both counts set to 0
    just before the run and read just after, and kept in ``LAUNCHES``).
    Returns the last result, the mean seconds per run and the peak memory."""
    slam(frames)
    torch.cuda.synchronize()
    secs = []
    for _ in range(TIMED_RUNS):
        torch.cuda.reset_peak_memory_stats()
        knn_cuda.launches = 0
        scatter_cuda.launches = 0
        t0 = time.perf_counter()
        pc, poses = slam(frames)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        LAUNCHES[path] = {"knn": knn_cuda.launches, "scatter": scatter_cuda.launches}
        expect = {"knn": expect_knn, "scatter": SCATTER_LAUNCHES[path]}
        if LAUNCHES[path] != expect:
            raise AssertionError(f"{path}: launches {LAUNCHES[path]}, expected {expect}")
    peak = torch.cuda.max_memory_allocated()
    return pc, poses, float(np.mean(secs)), peak


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


def production_phase():
    """The production recipe on the 640x480 hard clip against the JAX
    package's CPU golden. Returns the pipeline, the frames, the mean
    seconds a run and the launch count of the last run."""
    golden = np.load(GOLDEN)
    rgb, depth, K, P = hard_sequence(B, L, H, W)
    frames = rgbdimages_from_numpy(rgb, depth, K, P, device="cuda")
    slam = PointFusion(**PRODUCTION)
    pc, poses, secs, peak = timed_runs(slam, frames, "production_hard", PROD_LAUNCHES_PER_RUN)
    ref = int(golden["num_points"])
    count = check_map(pc, poses, ref, "production", rel=PROD_COUNT_REL)
    est = poses[0].cpu()
    ate = float(ate_rmse(est, torch.from_numpy(P[0])))
    if not ate <= PROD_ATE_BAR_M:
        raise AssertionError(f"production: aligned ATE {ate} m above {PROD_ATE_BAR_M} m")
    gap = np.linalg.norm(est.numpy()[:, :3, 3] - golden["poses"][:, :3, 3], axis=-1)
    log(f"PointFusion(production recipe) hard {H}x{W}x{L}: {L / secs:.4f} frames/s "
        f"({secs:.4f} s/run, mean of {TIMED_RUNS}), aligned ATE {ate:.6f} m "
        f"(JAX CPU golden {float(golden['ate_m']):.6f} m), map {count} points "
        f"(golden {ref}, {100 * (count - ref) / ref:+.3f}%), 0 dropped, "
        f"launches a run {LAUNCHES['production_hard']}, peak memory {peak} B")
    log("production: per-frame translation gap to the JAX CPU golden (m): "
        + " ".join(f"{g:.4f}" for g in gap) + f"; max {gap.max():.6f} at frame {int(gap.argmax())}")
    return slam, frames, secs


def pointclouds_to(pc, device):
    return dataclasses.replace(pc, **{
        f.name: getattr(pc, f.name).to(device)
        for f in dataclasses.fields(pc) if getattr(pc, f.name) is not None
    })


def small_recipe_agrees_with_cpu() -> None:
    """The production recipe at 160x120x9 on the card and on the CPU.

    - Each frame's step (localization and fusion) from the CPU run's state:
      poses within 2e-4, equal map counts. The kernel returns the plain
      version's distances bit for bit, but cuBLAS and the CUDA reductions
      round the solver's iterates differently from the CPU's, and one 1-NN
      near-tie that flips moves a step's pose by up to about 1e-4 (measured
      1.06e-4 on one of 8 steps, NVIDIA H100 80GB HBM3, 700 W).
    - The two whole runs: frame 1 within 1e-4, every frame within 5e-3,
      counts within 0.2%. The hard clip amplifies the steps' gaps from
      frame to frame (1-NN near-ties, Tukey and distance gates, and the
      constant-velocity prediction carries each gap into the next frame),
      as for the port against the JAX package on the CPU
      (``tests/port/test_torch_recipe.py``).
    """
    rgb, depth, K, P = hard_sequence(1, SMALL_L, SMALL_H, SMALL_W)
    runs = {}
    for dev in ("cuda", "cpu"):
        frames = rgbdimages_from_numpy(rgb, depth, K, P, device=dev)
        pc, poses = PointFusion(**SMALL)(frames)
        runs[dev] = (int(pc.num_points[0]), poses.cpu().numpy())
    gap = np.abs(runs["cuda"][1] - runs["cpu"][1]).reshape(SMALL_L, 16).max(-1)
    nc, nh = runs["cuda"][0], runs["cpu"][0]
    if not (gap[1] <= 1e-4 and (gap <= 5e-3).all() and abs(nc - nh) <= 0.002 * nh):
        raise AssertionError(f"small recipe whole runs: card vs CPU gaps {gap}, counts {nc} vs {nh}")

    slam = PointFusion(**SMALL)
    frames = {d: rgbdimages_from_numpy(rgb, depth, K, P, device=d) for d in ("cuda", "cpu")}
    cap = SMALL["map_capacity"]
    cpu_map = slam._map(slam.empty_map(1, cap, device="cpu"), frames["cpu"][:, 0])
    prev = frames["cpu"].poses[:, 0]
    delta = torch.eye(4)[None]
    step_gap = []
    for f in range(1, SMALL_L):
        pred = orthonormalize_rotations(compose_transformations(delta, prev))
        live = {d: RGBDImages(frames[d].rgb_image[:, f:f + 1], frames[d].depth_image[:, f:f + 1],
                              frames[d].intrinsics, pred[:, None].to(d))
                for d in ("cuda", "cpu")}
        pose = slam._localize(cpu_map, live["cpu"], live["cpu"])
        card_pose = slam._localize(pointclouds_to(cpu_map, "cuda"), live["cuda"], live["cuda"])
        step_gap.append(float((card_pose.cpu() - pose).abs().max()))
        card_map = slam._map(pointclouds_to(cpu_map, "cuda"), live["cuda"].with_poses(pose.cuda()))
        cpu_map = slam._map(cpu_map, live["cpu"].with_poses(pose))
        if int(card_map.num_points[0]) != int(cpu_map.num_points[0]):
            raise AssertionError(f"small recipe frame {f}: card map {int(card_map.num_points[0])} "
                                 f"vs CPU {int(cpu_map.num_points[0])}")
        if (f + 1) % SMALL["prune_every"] == 0:
            cpu_map = slam._prune(cpu_map)
        delta = compose_transformations(pose[:, 0], inverse_transformation(prev))
        prev = pose[:, 0]
    if not max(step_gap) <= 2e-4:
        raise AssertionError(f"small recipe steps: card vs CPU pose gaps {step_gap}")
    log(f"small recipe {SMALL_H}x{SMALL_W}x{SMALL_L}: per-step card vs CPU max |dpose| "
        f"{max(step_gap):.3e}; whole runs: per-frame max |dpose| "
        + " ".join(f"{g:.2e}" for g in gap) + f", counts {nc} vs {nh}")


def quantized_headline(frames, pc_gt) -> float:
    """``bench.py``'s headline, gt with quantized colors, on the easy clip:
    the float-color map's count and points. Returns the mean seconds a
    run."""
    slam = PointFusion(odom="gt", quantize_colors=True, map_capacity=SCHEDULE)
    pc, poses, secs, peak = timed_runs(slam, frames, "gt_quantized_easy", 0)
    n = check_map(pc, poses, int(pc_gt.num_points[0]), "gt quantized", rel=0.0)
    pts_err = float((pc.points[0, :n] - pc_gt.points[0, :n]).abs().max())
    cc_err = float((pc.features[0, :n, 0] - pc_gt.features[0, :n, 0]).abs().max())
    if not (pts_err <= 1e-6 and cc_err <= 1e-6):
        raise AssertionError(f"gt quantized: points {pts_err}, ccounts {cc_err} from the float map")
    col_err = float((PointFusion.decode_map(pc).colors[0, :n] - pc_gt.colors[0, :n]).abs().max())
    log(f"PointFusion(gt, quantize_colors) {H}x{W}x{L}: {L / secs:.4f} frames/s "
        f"({secs:.4f} s/run), map {n} points = the float-color map's, max |dpoint| "
        f"{pts_err:.3e}, max |dccount| {cc_err:.3e}, max |dcolor| {col_err:.4f} "
        f"({col_err * 255:.2f} 8-bit steps), peak memory {peak} B")
    return secs


def device_busy_s(prof) -> float:
    """Seconds of a ``torch.profiler`` run in which the device ran at least
    one kernel, copy or memset: the union of the device events' spans. A
    dependent launch (the scatter's row kernel) runs beside the kernel it
    follows, so the sum of the events' times would count that overlap
    twice."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy_us, end = 0.0, float("-inf")
    for start, stop in spans:
        if stop > end:
            busy_us += stop - max(start, end)
            end = stop
    return busy_us / 1e6


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
    # Device-side events only (kernels, copies, memsets)
    device = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    summed = sum(e.self_device_time_total for e in device) / 1e6
    busy = device_busy_s(prof)
    log(f"profile {tag}: wall {wall:.4f} s, device busy {busy:.4f} s "
        f"({100 * busy / wall:.1f}% of this profiled run; "
        f"{100 * busy / unprofiled_s:.1f}% of the unprofiled mean {unprofiled_s:.4f} s "
        f"in this process; the events' summed time {summed:.4f} s counts dependent "
        f"launches' overlap twice), {sum(e.count for e in device)} device events")
    top = sorted(device, key=lambda e: e.self_device_time_total, reverse=True)[:15]
    for e in top:
        log(f"  {e.self_device_time_total / 1e3:10.3f} ms  {e.count:6d}x  {e.key[:90]}")
    ours = [e for e in device if any(k in e.key for k in (
        "::knn1_", "::scatter_rows<", "::scatter_fill_copy<"))]
    log(f"profile {tag}: the port's kernels: " + "; ".join(
        f"{kernel_name(e.key)} {e.self_device_time_total / 1e3:.3f} ms "
        f"{e.count}x" for e in sorted(ours, key=lambda e: e.key)))


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
    log("ptxas report:\n" + (_build.build_log.strip() or "(library already built)"))

    rgb, depth, K, P = synthetic_sequence(B, L, H, W, seed=0)
    frames = rgbdimages_from_numpy(rgb, depth, K, P, device="cuda")
    hard = rgbdimages_from_numpy(*hard_sequence(1, 2, H, W), device="cuda",
                                 normal_pitch=PRODUCTION["normal_pitch"])
    icp_clip = rgbdimages_from_numpy(*synthetic_sequence(B, L, ICP_H, ICP_W, seed=0),
                                     device="cuda")
    t0 = time.perf_counter()
    knn = knn_phase(frames, hard, icp_clip)
    log(f"knn phase: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    scatter = scatter_phase()
    log(f"scatter phase: {time.perf_counter() - t0:.2f} s")

    small_clip_agrees_with_cpu()

    tracked = PointFusion(odom="gradicp", dsratio=DSRATIO, numiters=NUMITERS,
                          map_capacity=SCHEDULE)
    pc, poses, secs, peak = timed_runs(tracked, frames, "tracked_easy", KNN_LAUNCHES_PER_RUN)
    count = check_map(pc, poses, REF_COUNT_GRADICP, "gradicp")
    ate = ate_m(poses[0].cpu().numpy(), P[0])
    if not ate <= ATE_BAR_M:
        raise AssertionError(f"gradicp: ATE {ate} m above {ATE_BAR_M} m")
    log(f"PointFusion(gradicp) {H}x{W}x{L}: {L / secs:.4f} frames/s "
        f"({secs:.4f} s/run, mean of {TIMED_RUNS}), ATE {ate:.4e} m, "
        f"map {count} points, 0 dropped, launches a run {LAUNCHES['tracked_easy']}, "
        f"peak memory {peak} B")

    gt = PointFusion(odom="gt", map_capacity=SCHEDULE)
    pc_gt, poses_gt, secs_gt, peak_gt = timed_runs(gt, frames, "gt_easy", 0)
    count_gt = check_map(pc_gt, poses_gt, REF_COUNT_GT, "gt")
    log(f"PointFusion(gt) {H}x{W}x{L}: {L / secs_gt:.4f} frames/s "
        f"({secs_gt:.4f} s/run), map {count_gt} points, 0 dropped, "
        f"peak memory {peak_gt} B")

    profile_run(tracked, frames, "gradicp", secs)
    profile_run(gt, frames, "gt", secs_gt)

    prod, hard_frames, secs_prod = production_phase()
    small_recipe_agrees_with_cpu()
    quantized_headline(frames, pc_gt)
    profile_run(prod, hard_frames, "production", secs_prod)

    icp_frames, icp_runs = icpslam_phase()
    flat_slam, flat_secs = icp_runs["flat"]
    profile_run(flat_slam, icp_frames, "icpslam flat", flat_secs)

    # launches a run on each path, as counted in its last timed run
    knn_per_path = {path: n["knn"] for path, n in LAUNCHES.items()}
    scatter_per_path = {path: n["scatter"] for path, n in LAUNCHES.items()}
    tracked_shape = knn["shapes"][0]
    script = scatter["shapes"][0]
    print(json.dumps({"kernels": [{
        "name": "knn1_cuda",
        "route": "cuda",
        "source": "gradslam_torch/ops/csrc/knn.cu",
        "replaces": "gradslam_tpu/ops/knn_pallas.py:41",
        "launches": sum(knn_per_path.values()),
        "launches_per_path": knn_per_path,
        "max_abs_err": knn["max_abs_err"],
        "ms": tracked_shape["ms"],
        "plain_ms": tracked_shape["plain_ms"],
        "bound_ms": tracked_shape["bound_ms"],
        "bound_by": tracked_shape["bound_by"],
        "library_ms": None,  # no single PyTorch call computes a masked 1-NN
        "sm_clock_hz": knn["sm_clock_hz"],
        "shapes": knn["shapes"],
    }, {
        "name": "scatter_rows_cuda",
        "route": "cuda",
        "source": "gradslam_torch/ops/csrc/scatter.cu",
        "replaces": "scripts/microbench_scatter.py:60",
        "launches": sum(scatter_per_path.values()),
        "launches_per_path": scatter_per_path,
        "max_abs_err": scatter["max_abs_err"],
        "ms": script["ms"],
        "plain_ms": script["plain_ms"],
        "bound_ms": script["bound_ms"],
        "bound_by": "bytes",
        "library_ms": script["library_ms"],
        "shapes": scatter["shapes"],
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
