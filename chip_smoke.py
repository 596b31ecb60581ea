#!/usr/bin/env python3
r"""Smoke test of the PyTorch / CUDA port (``gradslam_torch``) on one GPU.

Run from the root of a checkout, with no arguments, on a machine with one
NVIDIA H100:

    python3 chip_smoke.py

Phases (each raises on failure; nothing is caught):

1. print the card's name and power limit; require CUDA; turn TF32 off;
2. build the CUDA kernels (``gradslam_torch/ops/csrc/knn.cu``, the 1-NN
   search, and ``scatter.cu``, the unique-row scatter; one ``nvcc`` each, in
   parallel) from the checkout's sources and print the build time; build
   the frame decoder's host library (``gradslam_torch/datasets/csrc/
   frameio.cpp``, ``g++``) and print its build time;
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
11b. the graph phase (``graph_phase``, PR 13): ``use_jit`` on the card.
    Tracked ``PointFusion(odom='gradicp', dsratio=4, numiters=10)``, gt and
    the production recipe at 640x480x30, ICPSLAM flat and window + pyramid
    at 320x240x30 and the tracked ``step`` loop (constant velocity, at
    ``ONLINE_CAP``), each with ``use_jit=False`` and then ``use_jit=True``
    on the same frames, a fresh pipeline each: a first call (with the
    warm-ups under ``torch.cuda.set_sync_debug_mode("error")`` and the
    captures) and a steady-state call, both kernels' launches counted from 0
    in each and held to the path's counts; poses and map SHA-256-equal
    between the modes and the calls; ``last_call_captured`` equal to
    ``use_jit``; the first call's result unchanged after later calls
    replayed its graphs; frames/s of both calls, device busy share and
    events (a device-only profile), capture seconds, graphs and peak memory
    of each mode. A gradient row and an armed row run captured (the armed
    row's graphs a gate and a fuse graph), and one 1-NN call (three
    kernels) is captured, replayed after other allocations and on new
    points, and held bit for bit to its eager call. Every other phase runs
    its pipelines with the default ``use_jit=True`` (captured, armed or
    not, with or without gradients), except the semantic rows and each
    gradient row's spied eager step, which spy on each kernel call and so
    run with ``use_jit=False``; the armed rows run in both modes;
12. the differentiability slice: gradients of ``sum(points^2)`` of the map
    to the depth images and the intrinsics (``scripts/bench_all.py:682-840``).
    (a) On a B=2 64x48x4 clip, gt sort_full, gt windowed + scatter, gradICP
    1-NN and gradICP projective with symmetric normals: the card's
    gradients within 1e-4 (gt) or 1e-3 (tracked) of the largest of the CPU
    run's, and ``remat=True`` against ``remat=False`` on the card: equal
    SHA-256 digests of poses and map points, gradients within the same bars;
    ``chamfer_distance`` card against CPU, and the gradient example's
    ``refine()`` on the card at its CPU test's settings and bars.
    (b) The bench_all rows at full width (``GRAD_ROWS``), each with
    ``use_jit=False`` and then captured (``grad_row``; the eager steps
    unprofiled, as the profiler slows them 1.3-3.2x): s/step first and
    steady, device busy share and events, graphs, capture s, peak memory
    (the captured steady step's own peak within ``GRAD_PEAK_SLACK`` of
    eager's) and what the graphs keep resident, finite nonzero max |g|,
    map, poses and gradients captured against eager, both kernels'
    launches in the forward and in the backward phase (recompute and
    backward) against ``grad_launches`` (the profiled step's device trace
    showing none more); the scatter kernel against its
    plain version on the warm-up's own scatter inputs (forward tables, the
    scatter merge and its buffer gradient in the backward) and on
    batch-distinct payloads at the same shapes; the B=8 rows' gradients and
    map counts against the CPU run of the same code; remat must lower gt
    640x480x30's peak. (c) gt 640x480x30 and gradICP 320x240x30 with remat
    against the JAX package's CPU gradients (``tests/port/data/
    grad_jax_cpu.npz``, bars ``GRAD_GOLDEN_BARS``). (d) A profile of one gt
    640x480x30 remat step. (e) The armed rows (``ARMED_GRAD_ROWS``: the
    kidnap 1-NN row at 640x480x11, its relocalization on frame 8 crossed
    by the gradient, and the same row with the anchor armed,
    ``anchor_every=3``), the last of ``GRAD_ROWS``, with remat off (the
    JAX package's default) and on, as (b): their launches derived from
    their branch frames, the same branch frames in every step of both
    modes; captured, each tracked frame one ``'armed'`` graph pair whose
    branches and their VJPs are conditional nodes decided on the device,
    at most two reads a step (``check_armed_grad_graph``); without remat
    each branch's residuals kept in its store only on the frames where it
    ran: the first step grows the stores once (its forward runs twice and
    reads once more), no later step grows them, and they hold what the
    branches that ran saved. (f) The online step loop under grad
    (``ONLINE_GRAD_ROWS``: gt and gradICP 1-NN ``step`` at 640x480x10,
    remat on), eager and captured (``online_grad_row``): map and poses
    SHA-256-equal, depth gradients SHA-256-equal where two eager steps
    agree, else and the intrinsics within ``GRAD_SUM_ORDER_BAR`` of max
    |g|, the same launches in every step (a profiled captured step's
    device trace showing none more), s/step first and steady, busy share;
13. the recovery slice (before the gradient phase; ``recovery_phase``), each
    row held against the JAX package's CPU run of it
    (``tests/port/data/recovery_jax_cpu.npz``, ``large_map_jax_cpu.npz``):
    (1) the kidnapped clip of ``tests/slam/test_inscan_relocalize.py`` at
    640x480 armed with the 1-NN and the projective tracker: post-kidnap
    unaligned RMSE below 0.02 m and within 2x of the golden's, the
    relocalization on the golden's frames, the unarmed run lost (above
    0.05 m), each armed row run eagerly and beside it captured (a gate
    graph, one read back and a fuse graph a frame), first call and
    replayed SHA-256-equal to eager on the same relocalization frames with
    the same launches (a replay's added up by the counters, and a profiled
    replay's device trace showing no more kernels than derived; the kernels
    line lists the eager counts); ``relocalize``
    alone with the K=5 default grid as one batch of 5 and one hypothesis
    at a time (same winner); (2) the armed healthy rows on the easy
    640x480 clip's first 15 frames (``ARMED_L``), eager and captured:
    poses and map SHA-256-equal to
    the unarmed run, no branch run, equal launches in both modes (the
    captured rows' device trace showing no more kernels than derived), one
    read back a tracked frame (a synchronizing operation more than the
    unarmed row of the same mode), frames/s, device busy share and events,
    device-to-device copies and peak memory against the unarmed row of the
    same mode, and the device time of one copy of the map; (3) the drift clip of
    ``tests/slam/test_anchor_recover.py`` card against CPU frame by frame
    within 2e-4 (same branches), the plain run drifting, the anchored one
    re-solving (eagerly, and captured beside it as the kidnap rows), their
    errors reported beside the golden's
    (``DRIFT_MIN_FINAL_M``); (4) sub-pixel association,
    with and without point rows, on the easy clip: aligned ATE within 2x
    of the golden, map within 0.2%; the hard-clip row card against CPU at
    160x120x9 frame by frame, and at 640x480x30 beside the golden; (5) the
    large map (``scripts/bench_all.py:633-680``), gt, gt quantized and
    tracked: 0 dropped, maps within 0.2% of the golden, tracked ATE within
    2x; then the 1-NN kernel at the relocalization's B=5 shape and the
    anchor re-solve's, and the scatter kernel at the large map's last-frame
    tables, each against its plain version and timed as in phases 3 and 3b;
14. the semantic, online and K-NN slice (after the recovery phase;
    ``semantic_online_phase``): (1) the ``SEMANTIC_ROWS`` (gt with the
    gather and, at ``SEM_SCATTER_CAP``, the scatter merge, each with float
    and quantized colors; tracked gradICP; ICPSLAM's aggregate map at
    320x240) with ``feature_channels=21`` and a one-hot plane of each
    pixel's world-x stripe (``stripe_plane``), each beside the same run
    with no features: map within 0.2% of the JAX package's CPU run
    (``tests/port/data/semantic_jax_cpu.npz``), each channel's sum within
    1e-3 of the golden's, each point's features summing to 1 within 1e-5,
    the argmax class the stripe of the point's own x on 99% of points,
    geometry, colors, confidences and poses SHA-256-equal to the
    featureless run, the tracked row's aligned ATE within 2x of the
    golden's and ``rpe`` on the golden's poses within 1e-3 of JAX's;
    frames/s and peak memory beside the featureless run's; (2) the online
    API at ``ONLINE_CAP``: ``forward``, the ``step`` loop and the
    ``localize`` -> ``map_update`` loop with equal digests and launches;
    (3) ``knn_points(K=17)`` and ``estimate_normals(k=16)`` on frame 0's
    stride-4 cloud against the golden, ``knn_points(K=1)`` against
    ``nn_points_auto``, and on the full 307,200-point cloud: sampled rows'
    K sets against a brute-force row, normals within 5 degrees of the
    frame's on 99% of interior pixels, and the time; (4) the 1-NN kernel at
    the stride-4 cloud's shape and the scatter kernel at the F=21 features
    write-backs (88- and 92-byte rows), the window compaction at
    ``SEM_SCATTER_CAP`` and the F=21 aggregate append, each against its
    plain version and timed as in phases 3 and 3b;
15. the dataset slice (after the semantic phase; ``dataset_phase``), from
    disk to disk at 640x480x30: a TUM-format and an ICL-format tree written
    from a seed with the port's PNG encoder (rows cycling through every
    filter, ICL at its negative fy); the frame decoder's library bit-equal
    to the plain numpy codec on every file of both trees; the host's decode
    time a colour and a depth frame (library and plain codec) and the
    sample's load time with both loaders, each sample equal to the arrays
    written under its own depth arithmetic, no process started;
    ``examples.pointfusion.main`` on the TUM tree (gradICP at the default
    capacity 9,216,000, fusion modes ``'auto'``): map within 0.2% of the JAX
    package's CPU run (``tests/port/data/dataset_jax_cpu.npz``), 0 dropped,
    unaligned ATE within 2x the golden's, poses, map and both kernels'
    launches equal to the in-memory run of the same arrays, its wall time
    and the part spent loading; the ``'native'`` sample through
    ``PointFusion`` (gradICP, ``dsratio=4``) SHA-256-equal to the in-memory
    run of the native arithmetic, with the same launches;
    ``examples.icpslam.main`` on the ICL tree resized to 320x240: the map
    exactly the valid pixel count, aligned ATE within 2x the golden's;
    ``examples.online_slam.main`` through 30 frames, through 15 and resumed
    to 30: the resumed run SHA-256-equal to the uninterrupted one,
    ``map.ply`` and ``trajectory.txt`` read back; both kernels against their
    plain versions on the pointfusion run's own inputs, timed at its new
    shapes;
16. the structures slice (after the dataset phase; ``structures_phase``):
    (a) the dense reference fusion path, ``find_correspondences`` +
    ``fuse_with_map``, over the 640x480x30 clip with gt poses and the gt
    schedule, at every frame from the same map against
    ``update_map_fusion(association='sort_full')``: equal counts, the live
    rows within 1e-5 row for row and column by column sorted, the
    confidence mass within 1e-5 relative; two timed runs with 4 * 30 = 120
    scatter launches each (one a buffer in ``append_masked``) and no 1-NN,
    bit-equal to the lockstep run; the map within 0.2% of the reference's
    516,214 with 0 dropped and within 0.2% of phase 5's map (the count gap
    and the share of rows within 1e-5 reported), s/run beside phase 5's;
    (b) the scatter kernel bit-equal to its plain version on the last
    frame's four append calls, timed at the 12- and 4-byte rows into the
    532,480-row map; (c) every ``Pointclouds`` operation, operator and
    ``*_`` name on phase 5's map against the same on a CPU copy (points and
    normals within 1e-5, a projection's pixels also within 1e-6 of their
    size, the padding exactly zero, the input's SHA-256 unchanged), indexing,
    ``from_list`` and the tensor round trips exact, ``RGBDImages`` ``clone``,
    ``to``, ``cuda`` and the channels-first views at 640x480, ``transform``
    with TF32 allowed by the caller bit-equal to TF32 off, and its device
    time; TF32 off before and after;
17. the parallel slice (after the structures phase; ``sharded_phase``),
    under NCCL at world size 1 (``init_process_group('nccl')`` with a
    ``file://`` store, destroyed after): ``MapShardedPointFusion`` on the
    easy 640x480x30 clip at 614,400 rows, gt, gradICP with 1-NN association
    and gradICP with projective association (``SHARDED_ROWS``), each beside
    ``PointFusion`` at the same settings on the card (counts equal for gt
    and within 0.2% tracked, sorted rows within 1e-5 where the counts are
    equal, confidence mass within 1e-5, poses equal for gt and within 1e-5
    tracked, shard counters summing to the count, 0 dropped) and against
    the JAX package's 4-device CPU golden (``tests/port/data/
    sharded_jax_cpu.npz``: count within 0.2%, mass within 1e-3, tracked
    poses within 1e-4 and unaligned RMSE within 2x), with exact launch counts (``sharded_launches``: the
    scatter on every row, the 1-NN on the 1-NN row only) and the
    winner-table traffic exactly ``3 * K * B * H*W * 4`` bytes a fused
    frame, with ``use_jit=False``, then each captured beside it
    (``sharded_captured``: its frames replayed from one CUDA graph with the
    collectives inside; SHA-256-equal, the same launches and collective
    bytes and calls by tag, one graph, a replay's device trace showing no
    more launches than derived; s/run, busy share, capture s and peak
    memory beside ``PointFusion``'s); a 2-D ``(dp=1, map=1)`` mesh with ``batch_axis`` at B=2
    320x240x8; ``DataParallelSLAM(PointFusion(odom='gt'))`` at B=2
    640x480x8 SHA-256-equal to ``PointFusion``; the scatter kernel
    bit-equal to its plain version on the winner table, the append map and
    the window compaction, each timed;
18. the frame loader API (``loader_phase``): ``decode_color`` and
    ``decode_depth`` on the 640x480x30 TUM tree at 480x640 and 240x320
    bit-equal to a numpy transcription of ``native/frameio/frameio.cpp``'s
    arithmetic, ``FrameLoader`` (4 and 8 threads) and the TUM loader's
    ``'native'`` sample bit-equal to them, the host's ms a frame serially
    and through ``FrameLoader``, and no process left behind;
19. stop every process the script started that still runs (a guard, also
    on a failed run), then print the kernels' JSON line, the card's line,
    and the result line.

Every timed run counts both kernels' launches from 0 and must hit the
counts derived from the code (``KNN_LAUNCHES_PER_RUN``,
``PROD_LAUNCHES_PER_RUN``, ``ICP_KNN_LAUNCHES``, ``SCATTER_LAUNCHES``,
``grad_launches``, ``recovery_launches`` from the frames on which a run's
recovery branches ran, ``semantic_launches``, ``dataset_launches``,
``DENSE_SCATTERS_PER_FRAME``, ``sharded_launches``; the
online loops must launch what ``forward`` does); the kernels' line prints
the counts read in the runs.

Exits non-zero, printing no result, when no CUDA device is available.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import gc
import hashlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
import warnings
from pathlib import Path

# Kineto tears CUPTI down after each profiler session. Left up, CUPTI slows
# every later replay of a CUDA graph with conditional nodes by 20-30% (the
# armed captured rows after one profiled run; PERF.md §7), and the script
# profiles before it times them.
os.environ.setdefault("TEARDOWN_CUPTI", "1")

import numpy as np
import torch

from gradslam_torch import (
    ICPSLAM,
    Pointclouds,
    PointFusion,
    RGBDImages,
    estimate_normals,
    hard_sequence,
    perturbation_grid,
    pointclouds_from_rgbdimages,
    relocalize,
    synthetic_sequence,
)
from gradslam_torch.datasets import TUM, frameio
from gradslam_torch.datasets import base as base_module
from gradslam_torch.datasets.datautils import scale_intrinsics
from gradslam_torch.datasets import synthetic as synthetic_module
from gradslam_torch.examples import gradient_refinement
from gradslam_torch.examples import icpslam as icpslam_example
from gradslam_torch.examples import online_slam as online_example
from gradslam_torch.examples import pointfusion as pointfusion_example
from gradslam_torch.geometry import (
    compose_transformations,
    inverse_transformation,
    orthonormalize_rotations,
    se3_exp,
)
from gradslam_torch.interop import rgbdimages_from_numpy
from gradslam_torch.metrics import ate_rmse, chamfer_distance, rpe
from gradslam_torch.odometry.icputils import downsample_rgbdimages
from gradslam_torch.ops import _build, knn_cuda, knn_points, nn_points, nn_points_auto, scatter_cuda
from gradslam_torch.ops._build import load_library
from gradslam_torch.ops.scatter import scatter_rows_into_plain, scatter_rows_plain
from gradslam_torch.slam.fusionutils import (
    ActiveMapPoints,
    _project_map_points,
    _resolve_modes,
    find_active_map_points,
    find_best_unique_correspondences,
    find_correspondences,
    find_similar_map_points,
    fuse_with_map,
    update_map_fusion,
)
from gradslam_torch.slam import icpslam as icpslam_module
from gradslam_torch.slam.icpslam import armed_on_device
from gradslam_torch.structures import pointclouds as pointclouds_module
from gradslam_torch.structures.io import load_ply
from gradslam_torch.structures.pointclouds import scatter_rows, scatter_rows_into
from gradslam_torch.utils import graphs as graphs_module
from gradslam_torch.utils.precision import disable_tf32, tf32_disabled
from gradslam_torch.utils.trajectory_io import load_trajectory_tum

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

# The differentiability slice: gradients of sum(points^2) of the final map
# with respect to the depth images and the intrinsics, through PointFusion
# on synthetic_sequence(B, L, H, W, seed=0) (scripts/bench_all.py:682-840).
# (a) a small clip, card against CPU and remat on against off, with the bars
# of the CPU tests against jax.grad (tests/port/test_torch_grad*.py):
GRAD_SMALL = (2, 4, 48, 64)
GRAD_SMALL_CONFIGS = {
    "gt_sort_full": (dict(odom="gt", association="sort_full", merge="gather"), 1e-4),
    "gt_windowed_scatter": (dict(odom="gt", association="windowed", merge="scatter",
                                 map_capacity=4 * 4 * 48 * 64), 1e-4),
    "gradicp_knn": (dict(odom="gradicp", dsratio=4, numiters=10), 1e-3),
    "gradicp_projective_sym": (dict(odom="gradicp", dsratio=4, numiters=10,
                                    odom_assoc="projective", odom_sym_normals=True), 1e-3),
}
# chamfer_distance card against CPU, and the gradient example on the card at
# its CPU test's settings (tests/port/test_torch_grad.py:
# test_example_chamfer_recovers_calibration). The chamfer's expanded form
# |a|^2 + |b|^2 - 2a.b rounds at the scale of |a|^2 (metres squared), not
# of a pair's squared distance (centimetres squared here, the clouds parting
# by 8% in depth): a.b summed in another order on the card moves a pair by
# more than the 1e-5 that the CPU test holds against JAX's same sums.
EXAMPLE_CHAMFER_BAR = 1e-4
EXAMPLE_REFINE = dict(H=24, W=32, L=3, steps=25, lr=0.08)
# (b) the bench_all rows at full width, nothing cut: name -> ((B, L, H, W),
# capacity, options, remat settings). 'auto' resolves the fusion modes as in
# JAX: gt 120x160 windowed + gather, gt 320x240 B=8 windowed + scatter, every
# other row sort_full + gather.
GRADICP = dict(odom="gradicp", dsratio=4, numiters=10)
GRAD_ROWS = {
    "gt_B8_160x120x4": ((8, 4, 120, 160), 76_800, dict(odom="gt"), (False,)),
    # 4 frames, not the bench row's 8: the script's time limit (PERF.md §4)
    "gt_B8_320x240x4": ((8, 4, 240, 320), 614_400, dict(odom="gt"), (True,)),
    "gt_640x480x30": ((1, 30, 480, 640), 540_672, dict(odom="gt"), (False, True)),
    "knn_320x240x30": ((1, 30, 240, 320), 147_456, GRADICP, (True,)),
    # remat off on 10 of its 30 frames: the script's time limit (PERF.md §4)
    "knn_320x240x10": ((1, 10, 240, 320), 147_456, GRADICP, (False,)),
    # 10 frames, not the bench row's 30: the script's time limit (PERF.md §4)
    "knn_640x480x10": ((1, 10, 480, 640), 540_672, GRADICP, (True,)),
    # 30 frames: at 15 its two eager steps can agree by chance where the
    # captured one differs by an atomic add's rounding
    "projective_640x480x30": ((1, 30, 480, 640), 540_672,
                              dict(GRADICP, odom_assoc="projective", odom_sym_normals=True),
                              (False, True)),
}


def fusion_modes(name: str) -> tuple:
    """A row's fusion ``(association, merge)``, as fusion resolves
    ``'auto'`` (``fusionutils._resolve_modes``; the window defaults to
    ``2 * H * W`` rows)."""
    (_, _, H, W), cap, kw, _ = GRAD_ROWS[name]
    window = min(kw.get("active_capacity") or 2 * H * W, cap)
    return _resolve_modes(kw.get("association", "auto"), kw.get("merge", "auto"),
                          cap, H * W, window)


def grad_launches(name: str, log: dict) -> dict:
    """Launches of one gradient step of a row, derived from the code given
    the frames on which its recovery branches ran (its ``recovery_log``):
    ``{kernel: (forward, backward, recompute)}``. The forward is
    :func:`recovery_launches`'. The backward launches the scatter once for
    each scatter merge whose old map needs a gradient (every frame but the
    first, whose map is the empty buffer); the 1-NN has no backward. With
    remat, the recompute runs each checkpointed body again, a branch's
    too: everything but a tracked row's bootstrap (frame 0's map update
    and, anchored, its anchor snapshot)."""
    (_, L, H, W), cap, kw, _ = GRAD_ROWS[name]
    fwd = recovery_launches(dict(kw, map_capacity=cap), (1, L, H, W), log)
    boot = 0 if kw["odom"] == "gt" else fusion_scatters(cap, H, W, kw)
    boot += 5 if kw.get("anchor_every") else 0
    merges = L - 1 if fusion_modes(name)[1] == "scatter" else 0
    return {"knn": (fwd["knn"], 0, fwd["knn"]),
            "scatter": (fwd["scatter"], merges, fwd["scatter"] - boot)}


# (c) the JAX package's CPU gradients of two rows with remat
# (tests/port/make_grad_golden.py): golden name -> row.
GRAD_GOLDEN = Path(__file__).resolve().parent / "tests/port/data/grad_jax_cpu.npz"
GRAD_GOLDEN_ROWS = {"gt": "gt_640x480x30", "knn": "knn_320x240x30"}
# "<row> remat=<on|off>" -> {"forward"|"backward": {kernel: n}}: the eager
# step's launches, counted where the wrappers launch
GRAD_LAUNCHES = {}
# A captured steady step's own peak memory (its peak less what was allocated
# when it started: the graphs, the results held) may exceed eager's by this
# share (allocator rounding of the arenas and per-call copies).
GRAD_PEAK_SLACK = 0.02
# Captured gradients against eager: the intrinsics gradient sums each
# frame's contribution inside its graph, then across frames in autograd,
# where eager adds every contribution to one buffer: the same terms in
# another order. Where the card's atomic adds make two eager steps' depth
# gradients differ, the captured one is held to the same bar.
GRAD_SUM_ORDER_BAR = 1e-6
# Bars of (c), relative (see gradient_gaps and PERF.md §2). The port's map
# parts from the JAX CPU run's at near-tie merges on either device (gt
# 640x480x30: JAX 516,221, the port's CPU run 516,216, the card 516,230;
# tests/port/grad_golden_witness.py), and a flipped merge moves the gradient
# of the pixels fused into that point: a few pixels may be far off, so the
# pixel bars are the 99th percentile, at the CPU tests' bars against
# jax.grad (1e-4 gt, 1e-3 tracked), at most 1% of the pixels off by more
# than 1e-3, and none of the golden's pixels off by more than 0.3 (the
# readings there: 0.115 gt, 0.030 tracked, the same on the CPU); the
# whole-gradient sums stay within 1e-3.
_GOLDEN_BARS = {"intrinsics": 1e-3, "sum": 1e-3, "abssum": 1e-3, "maxabs": 1e-3,
                "pixels_over_1e-3": 0.01, "pixels_worst": 0.3}
GRAD_GOLDEN_BARS = {"gt": dict(_GOLDEN_BARS, pixels_p99=1e-4),
                    "knn": dict(_GOLDEN_BARS, pixels_p99=1e-3)}
# The B=8 rows against the CPU run of the same code at every pixel: the gt
# bars, but the worst pixel is only reported. Among millions of pixels a
# merge that the card decides the other way moves a few pixels' gradients
# by as much as the largest (gt 640x480x30: 0.884 of max |g|, at 2,099 of
# 9,216,000 pixels, tests/port/grad_golden_witness.py); the share and the
# 99th percentile hold the rest.
GRAD_CPU_ROWS = ("gt_B8_160x120x4", "gt_B8_320x240x4")
GRAD_CPU_BARS = dict(GRAD_GOLDEN_BARS["gt"], pixels_worst=None)
GRAD_CPU_COUNT_REL = 0.002  # each clip's map count within 0.2% of the CPU's (§2)

# Tracking recovery, sub-pixel association and point rows, and the large
# map. The JAX package's CPU runs of these rows are the goldens
# tests/port/data/recovery_jax_cpu.npz and large_map_jax_cpu.npz
# (tests/port/make_recovery_golden.py, make_large_map_golden.py).
TUNED = dict(robust_loss="tukey", robust_scale=0.03, dist_thresh=0.01)
# (1) the kidnapped clip of tests/slam/test_inscan_relocalize.py:20-40 at
# full width: frames 0-7 pan, then the camera jumps back to frames 0-2.
KIDNAP_SHAPE = (1, 12, 480, 640)
KIDNAP_SPEED = 8.0
KIDNAP_ORDER = (0, 1, 2, 3, 4, 5, 6, 7, 0, 1, 2)
KIDNAP_BASE = dict(odom="gradicp", dsratio=4, numiters=10, **TUNED)
KIDNAP_ATE_BAR_M = 0.02  # post-kidnap unaligned translation RMSE, armed runs
KIDNAP_GOLDEN_FACTOR = 2.0  # ... and within 2x of the golden's
KIDNAP_UNARMED_MIN_M = 0.05  # the unarmed run must stay lost


def kidnap_clip() -> tuple:
    """``(rgb, depth, K, poses, jump)``: the kidnapped clip as arrays (frame
    order ``KIDNAP_ORDER``) and the camera-local jump from frame 7 back to
    frame 0 (a pure pan, so camera-local is the world delta)."""
    B_, L_, H_, W_ = KIDNAP_SHAPE
    rgb, depth, K, P = synthetic_sequence(B_, L_, H_, W_, speed=KIDNAP_SPEED)
    idx = list(KIDNAP_ORDER)
    return rgb[:, idx], depth[:, idx], K, P[:, idx], kidnap_jump(P)


def kidnap_jump(P=None) -> tuple:
    """The kidnap's camera-local jump from frame 7 back to frame 0 of the
    clip's poses ``P``; without them, of a 1x1 render of the clip (its
    poses do not depend on its size)."""
    if P is None:
        P = synthetic_sequence(1, 8, 1, 1, speed=KIDNAP_SPEED)[3]
    return tuple(float(x) for x in P[0, 0, :3, 3] - P[0, 7, :3, 3])


def kidnap_rows(jump) -> dict:
    """The kidnap rows' options on top of ``KIDNAP_BASE``: the 1-NN tracker
    and the projective tracker armed with the JAX test's grids, the
    unarmed tracker, and the 1-NN tracker with the keyframe anchor armed
    too (its relocalization's body runs the drift gate on the pose it
    leaves, whose flags the host reads once more)."""
    zero = (0.0, 0.0, 0.0)
    back = tuple(-x for x in jump)
    knn = dict(relocalize_below=0.5, relocalize_grid=dict(
        yaw_deg=(0.0,), translations=(zero, tuple(jump), back)))
    return {
        "knn": knn,
        "projective": dict(odom_assoc="projective", odom_angle_gate=60.0, relocalize_below=0.5,
                           relocalize_grid=dict(yaw_deg=(0.0,), translations=(zero, tuple(jump)))),
        "unarmed": {},
        "knn_anchor": dict(knn, anchor_every=3),
    }


# (e) of the gradient phase, armed recovery under grad: the kidnap 1-NN row
# at 640x480x11, its relocalization on frame 8 crossed by the gradient, and
# the same row with the keyframe anchor armed too (anchor_every=3: the
# anchor re-solve's and the refresh's conditionals under grad), remat off
# (the JAX package's default) and on; captured, each tracked frame is one
# graph pair with its branches decided on the device. Their inputs the
# kidnapped clip (GRAD_CLIPS), their launches derived from the frames their
# branches ran on (grad_launches)
ARMED_GRAD_ROW = "kidnap_knn_640x480x11"
ARMED_ANCHOR_GRAD_ROW = "kidnap_knn_anchor_640x480x11"
ARMED_GRAD_ROWS = (ARMED_GRAD_ROW, ARMED_ANCHOR_GRAD_ROW)
_KL = len(KIDNAP_ORDER)
for _name, _row in zip(ARMED_GRAD_ROWS, ("knn", "knn_anchor")):
    GRAD_ROWS[_name] = ((1, _KL, *KIDNAP_SHAPE[2:]), _KL * KIDNAP_SHAPE[2] * KIDNAP_SHAPE[3],
                        dict(KIDNAP_BASE, **kidnap_rows(kidnap_jump())[_row]), (False, True))
_kidnap_arrays = functools.lru_cache(maxsize=1)(lambda: kidnap_clip()[:4])
GRAD_CLIPS = {name: _kidnap_arrays for name in ARMED_GRAD_ROWS}


# (2) the armed healthy rows (scripts/bench_all.py:378-388, and :301-312 at
# full width) on the easy 640x480 clip (its first ARMED_L frames in the
# armed phase): armed, eager and captured, they must give the unarmed run's
# bits.
ARMED_BASE = dict(odom="gradicp", odom_assoc="projective", odom_sym_normals=True,
                  dsratio=4, numiters=10, map_capacity=SCHEDULE)
ARMED_ROWS = {"unarmed": {}, "relocalize": dict(relocalize_below=0.2),
              "relocalize_anchor": dict(relocalize_below=0.2, anchor_every=10)}
# (3) the drift clip of tests/slam/test_anchor_recover.py:44-72: projective
# odometry without symmetric normals drifts on noisy depth; the keyframe
# anchor cuts the error.
DRIFT_SHAPE = (1, 18, 120, 160)
DRIFT_BASE = dict(odom="gradicp", odom_assoc="projective", dsratio=4, numiters=10,
                  motion_model="constant_velocity", odom_angle_gate=60.0, **TUNED)
DRIFT_ROWS = {"plain": {}, "anchored": dict(relocalize_below=0.2, anchor_every=30)}
# The JAX test holds the anchored ATE below 0.65x the plain one on this clip
# (seed 0). That outcome is chaotic: the drift gate's conditional inlier
# fraction hovers at its 0.98 threshold and an adoption compares two inlier
# fractions at near-ties, so the frames that re-solve, and the error they
# leave, change with rounding. Over hard_sequence seeds 0-4 the anchored /
# plain ATE ratio is 0.50 / 0.63 / 4.24 / 0.54 / 1.00 in JAX and
# 0.98 / 0.53 / 1.49 / 0.86 / 1.00 in the port, both on the CPU. So the card
# reports the ratio and holds what is not chaotic: the plain run drifts
# (final error above DRIFT_MIN_FINAL_M, the JAX test's bar), the gate fires
# on the anchored run, and each step agrees with the CPU's (lockstep).
DRIFT_MIN_FINAL_M = 0.1
# (4) sub-pixel association and point rows: the easy clip (projective with
# symmetric normals, as ARMED_BASE) and the hard-clip row of
# scripts/bench_all.py:553-563, at full width and at 160x120 (strides and
# normal pitch cut by 4, as SMALL).
SUBPIXEL_ROWS = {"subpixel": dict(ARMED_BASE, odom_subpixel=True),
                 "subpixel_p025": dict(ARMED_BASE, odom_subpixel=True, odom_point_weight=0.25)}
SUBPIXEL_ATE_FACTOR = 2.0  # aligned ATE within 2x of the golden's
HARD_SUBPIXEL = dict(
    odom="gradicp", odom_assoc="projective", odom_sym_normals=True, odom_angle_gate=45.0,
    odom_point_weight=0.25, odom_subpixel=True, dsratio=4, numiters=10,
    map_capacity=L * H * W, motion_model="constant_velocity", robust_loss="tukey",
    robust_scale=0.02, dist_thresh=0.01, normal_pitch=4,
)
SMALL_SUBPIXEL = dict(HARD_SUBPIXEL, dsratio=1, normal_pitch=1,
                      map_capacity=SMALL_L * SMALL_H * SMALL_W)
# (5) the large map (scripts/bench_all.py:633-680): 60 frames at 640x480
# with a 4x-speed camera; the map passes 1.1M rows.
LARGE_SHAPE = (1, 60, 480, 640)
LARGE_SPEED = 4.0
LARGE_SCHEDULE = [
    (10, 438_272), (10, 614_400), (10, 763_904),
    (10, 896_000), (10, 1_028_096), (10, 1_160_192),
]
LARGE_ROWS = {
    "gt": dict(odom="gt"),
    "gt_quantized": dict(odom="gt", quantize_colors=True),
    "tracked": dict(odom="gradicp", odom_assoc="projective", odom_sym_normals=True,
                    pyramid=[(8, 6), (4, 2)], lookahead_assoc="reuse", quantize_colors=True,
                    motion_model="constant_velocity"),
}
LARGE_COUNT_REL = 0.002  # map within 0.2% of the golden's
LARGE_ATE_FACTOR = 2.0

# The semantic / online / K-NN slice (semantic_online_phase), against the JAX
# package's CPU runs of the same rows (tests/port/make_semantic_golden.py).
# The user plane is ScanNet's label width (20 classes and "unlabeled",
# examples/pointfusion_scannet.py:35) as a one-hot of each pixel's world x in
# 10 cm stripes (stripe_plane): a class that stays with the surface point
# from frame to frame, made from the clip's depths and poses.
SEM_F = 21
SEM_STRIPE_M = 0.1
SEM_SCATTER_CAP = 7 * H * W  # above 6 * H * W 'auto' fuses windowed + scatter
# name -> (pipeline, clip (B, L, H, W), options); each runs with feature_channels
# 0 and SEM_F
SEMANTIC_ROWS = {
    "gt": ("PointFusion", (B, L, H, W), dict(odom="gt", map_capacity=SCHEDULE)),
    "gt_scatter": ("PointFusion", (B, L, H, W), dict(odom="gt", map_capacity=SEM_SCATTER_CAP)),
    "gt_quantized": ("PointFusion", (B, L, H, W),
                     dict(odom="gt", quantize_colors=True, map_capacity=SCHEDULE)),
    "gt_quantized_scatter": ("PointFusion", (B, L, H, W),
                             dict(odom="gt", quantize_colors=True,
                                  map_capacity=SEM_SCATTER_CAP)),
    "tracked": ("PointFusion", (B, L, H, W),
                dict(odom="gradicp", dsratio=DSRATIO, numiters=NUMITERS, map_capacity=SCHEDULE)),
    "icpslam_gt": ("ICPSLAM", (B, L, ICP_H, ICP_W), dict(odom="gt", map_capacity=ICP_SCHEDULE)),
}
SEM_GOLDEN = Path(__file__).resolve().parent / "tests/port/data/semantic_jax_cpu.npz"
SEM_COUNT_REL = 0.002  # map within 0.2% of the golden's
# each channel's sum over the map within 1e-3 of the golden's; the tracked
# row's map parts from the golden's at near-tie merges (516,112 against
# 516,217 points, the same at F = 0), and its sums by up to 1.14e-3, so its
# channels are held to the map count's own bar
SEM_SUM_REL = {"gt": 1e-3, "tracked": SEM_COUNT_REL}
SEM_ONE_ATOL = 1e-5  # each fused point's one-hot average sums to 1
SEM_CLASS_MIN = 0.99  # argmax class = the stripe of the point's own x
SEM_ATE_FACTOR = 2.0
SEM_RPE_REL = 1e-3
# rpe's rotation is arccos((trace - 1) / 2) in float32: below 3.45e-4 rad
# (arccos(1 - 2**-24)) an angle rounds to 0, so two roundings of the same
# poses can part by that much whatever their relative gap
SEM_RPE_ROT_ATOL = 3.5e-4
# The online API at a fixed capacity, against forward at the same capacity.
ONLINE_CAP = SCHEDULE[-1][1]
ONLINE_ROWS = {
    "gt": dict(odom="gt", feature_channels=SEM_F),
    "tracked": dict(odom="gradicp", dsratio=DSRATIO, numiters=NUMITERS,
                    motion_model="constant_velocity"),
}
# K-NN and estimate_normals(k=16): K = 17 neighbours, on frame 0's stride-4
# cloud (19,200 points, against the golden) and its full cloud (307,200).
KNN_K = 17
KNN_STRIDE = 4
KNN_GOLDEN_NORMAL_ROWS = 4  # the golden keeps every 4th row's normal
KNN_NORMAL_ATOL = 1e-4
KNN_BRUTE_ROWS = 256
KNN_NORMAL_DEG = 5.0
KNN_NORMAL_MIN = 0.99
KNN_BORDER = 8  # interior pixels: this far from the frame's edge


def stripe_classes(depth: np.ndarray, K: np.ndarray, P: np.ndarray) -> np.ndarray:
    """``(B, L, H, W)`` int64 class of each pixel: ``floor((x_w + 10) /
    SEM_STRIPE_M) mod SEM_F`` of its world x (back-projected in float64 on
    the host, so the JAX golden and the card read the same classes); class 0
    where the depth is invalid."""
    d = depth[..., 0].astype(np.float64)
    _, _, h, w = d.shape
    K = K[:, 0].astype(np.float64)[:, None, None, None]  # (B, 1, 1, 1, 4, 4)
    u = np.arange(w, dtype=np.float64)[None, None, None, :]
    v = np.arange(h, dtype=np.float64)[None, None, :, None]
    xc = (u - K[..., 0, 2]) / K[..., 0, 0] * d
    yc = (v - K[..., 1, 2]) / K[..., 1, 1] * d
    R = P.astype(np.float64)[:, :, None, None]  # (B, L, 1, 1, 4, 4)
    xw = R[..., 0, 0] * xc + R[..., 0, 1] * yc + R[..., 0, 2] * d + R[..., 0, 3]
    cls = np.floor((xw + 10.0) / SEM_STRIPE_M).astype(np.int64) % SEM_F
    return np.where(d > 0, cls, 0)


def stripe_plane(depth: np.ndarray, K: np.ndarray, P: np.ndarray) -> np.ndarray:
    """The ``(B, L, H, W, SEM_F)`` float32 one-hot plane of
    :func:`stripe_classes`."""
    return np.eye(SEM_F, dtype=np.float32)[stripe_classes(depth, K, P)]


def stride_cloud(depth: np.ndarray, K: np.ndarray, P: np.ndarray) -> np.ndarray:
    """Frame 0's world-frame points at stride ``KNN_STRIDE``, ``(1, N, 3)``
    float32, back-projected in float64 on the host: the K-NN golden's input,
    the same bits on both sides."""
    d = depth[0, 0, ::KNN_STRIDE, ::KNN_STRIDE, 0].astype(np.float64)
    h, w = d.shape
    k = K[0, 0].astype(np.float64)
    u = np.arange(0, w * KNN_STRIDE, KNN_STRIDE, dtype=np.float64)[None, :]
    v = np.arange(0, h * KNN_STRIDE, KNN_STRIDE, dtype=np.float64)[:, None]
    cam = np.stack([(u - k[0, 2]) / k[0, 0] * d, (v - k[1, 2]) / k[1, 1] * d, d], -1)
    pose = P[0, 0].astype(np.float64)
    world = cam.reshape(-1, 3) @ pose[:3, :3].T + pose[:3, 3]
    return world[None].astype(np.float32)

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
# the same for runs replayed from graphs whose eager run is in LAUNCHES: the
# counters add each graph's captured launches on replay, so these are held
# against the eager counts and a device trace, and left out of the kernels line
CAPTURED_LAUNCHES = {}
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


def _descendants(pid: int) -> list:
    """The pids of every live process below ``pid``, read from ``/proc``."""
    children = {}
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except (OSError, IndexError):
            continue  # exited while we read
        if fields[0] != "Z":
            children.setdefault(int(fields[1]), []).append(int(entry))
    found, todo = [], [pid]
    while todo:
        below = children.get(todo.pop(), [])
        found += below
        todo += below
    return found


def stop_child_processes() -> list:
    """Stop every process this script started that is still running and
    return the pids it had to signal: a guard, as nothing of the port
    should leave one (``FrameLoader`` runs threads). A multiprocessing
    forkserver or resource tracker, which would run until the interpreter
    exits, is stopped and reaped; any other descendant gets SIGTERM, then
    SIGKILL after 5 s. Safe to call twice."""
    import signal
    from multiprocessing import forkserver, resource_tracker

    forkserver._forkserver._stop()
    resource_tracker._resource_tracker._stop()
    left = _descendants(os.getpid())
    for sig in (signal.SIGTERM, signal.SIGKILL):
        for pid in _descendants(os.getpid()):
            with contextlib.suppress(ProcessLookupError):
                os.kill(pid, sig)
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            with contextlib.suppress(ChildProcessError):
                while os.waitpid(-1, os.WNOHANG)[0]:
                    pass
            if not _descendants(os.getpid()):
                return left
            time.sleep(0.05)
    raise RuntimeError(f"processes {_descendants(os.getpid())} outlived SIGKILL")


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


def scatter_split_ms(table, dest, values, fill, rounds: int = 3) -> dict:
    """Device time a call of each of the scatter's two device kernels, from
    CUDA events behind a spin kernel (``device_ms``, medians of ``rounds``
    rounds of 10 calls): the fill (or copy) of the table alone, the wrapper
    called with no rows (``M = 0``), and the time the row kernel adds to it
    in a whole call (a dependent launch, which starts while the fill runs).
    Not ``torch.profiler``: its sessions of ten calls of a 10 us kernel
    read no device kernels late in this script. Raises unless both are
    finite."""
    no_dest = dest[:, :0].contiguous()
    no_values = values[:, :0].contiguous()
    fns = {"fill": lambda: scatter_kernel(table, no_dest, no_values, fill),
           "whole": lambda: scatter_kernel(table, dest, values, fill)}
    acc = {k: [] for k in fns}
    for _ in range(rounds):
        for key in ("fill", "whole", "whole", "fill"):
            acc[key].append(device_ms(fns[key], 10))
    fill_ms, whole_ms = (float(np.median(acc[k])) for k in ("fill", "whole"))
    split = {"scatter_fill_copy": fill_ms, "scatter_rows_added": whole_ms - fill_ms}
    if not all(math.isfinite(v) for v in split.values()) or fill_ms <= 0:
        raise AssertionError(f"scatter split: no device time read ({split})")
    return split


def kernel_name(key: str) -> str:
    """A profiler key without its return type, namespace and arguments:
    ``scatter_rows<unsigned int, int>``, ``Memcpy DtoD``."""
    found = re.search(r"(\w+(?:<[^()]*>)?)\(", key)
    return found.group(1) if found else key.split("(")[0].strip()


def time_scatter(name, table, dest, values, fill) -> dict:
    """One timed shape: device time a call (``device_ms``, medians of 2
    rounds of 10 calls of kernel, plain version, library call and an empty
    kernel, ``torch.cuda._sleep(0)``, the launch floor, taken in turns); the
    kernel's two device kernels apart (``scatter_split_ms``); its host time a
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
           "kernels_ms": scatter_split_ms(table, dest, values, fill),
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

    return union_s([(e.time_range.start, e.time_range.end) for e in prof.events()
                    if e.device_type == DeviceType.CUDA], 1e-6)


def union_s(spans, unit_s: float) -> float:
    """Seconds covered by the union of ``(start, stop)`` spans given in
    units of ``unit_s`` seconds."""
    busy, end = 0.0, float("-inf")
    for start, stop in sorted(spans):
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    return busy * unit_s


def check_profile(tag: str, busy: float, events: int) -> None:
    """A profiled run must read device activity: raises on 0 device events
    or a busy time that is not finite and positive."""
    if events <= 0 or not (math.isfinite(busy) and busy > 0):
        raise AssertionError(f"profile {tag}: the profiler read {events} device events and a "
                             f"device busy time of {busy} s")


def profile_run(run, tag: str, unprofiled_s: float) -> tuple:
    """One call of ``run`` under ``torch.profiler``: prints the wall time,
    the device's busy time, its share of this run's wall time and of
    ``unprofiled_s`` (the mean wall time of this process's unprofiled runs
    of the same work), and the kernels that take the most device time.
    Returns the busy seconds and the number of device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # Device-side events only (kernels, copies, memsets)
    device = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    summed = sum(e.self_device_time_total for e in device) / 1e6
    busy = device_busy_s(prof)
    check_profile(tag, busy, sum(e.count for e in device))
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
    return busy, sum(e.count for e in device)


def sha256_of(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


@functools.lru_cache(maxsize=None)
def grad_arrays(shape) -> tuple:
    """``synthetic_sequence(*shape, seed=0)``, made once for each shape (a
    640x480x30 clip takes seconds to render on the host)."""
    return synthetic_sequence(*shape, seed=0)


def grad_inputs(shape, device):
    """``synthetic_sequence(*shape, seed=0)`` as ``(rgb, depth, K, poses)``
    tensors on ``device``."""
    return tuple(torch.from_numpy(a).to(device) for a in grad_arrays(shape))


def row_inputs(name: str, device):
    """A gradient row's ``(rgb, depth, K, poses)`` on ``device``: its clip
    (``GRAD_CLIPS``), else :func:`grad_inputs` of its shape."""
    clip = GRAD_CLIPS.get(name)
    if clip is None:
        return grad_inputs(GRAD_ROWS[name][0], device)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in clip())


def grad_step(slam, inputs, spy=None, phase=contextlib.nullcontext):
    """One gradient step: the forward, ``sum(points^2)`` of the final map,
    its backward to the depth images and the intrinsics. Both kernels'
    counts are set to 0 just before the forward and read just after it,
    then set to 0 just before the backward and read just after it (the
    backward phase: the remat recompute and the backward's own launches).
    A :class:`ScatterSpy` is told where the backward starts; each phase
    runs inside ``phase("forward")`` and ``phase("backward")`` (a
    :class:`PhaseTrace`). Returns ``(pointclouds, poses, g_depth, g_K,
    launches)``."""
    rgb, depth, K, P = inputs
    d = depth.clone().requires_grad_()
    k = K.clone().requires_grad_()
    knn_cuda.launches = scatter_cuda.launches = 0
    with phase("forward"):
        pc, poses = slam(RGBDImages(rgb, d, k, P))
        loss = (pc.points ** 2).sum()
    fwd = {"knn": knn_cuda.launches, "scatter": scatter_cuda.launches}
    knn_cuda.launches = scatter_cuda.launches = 0
    if spy is not None:
        spy.forward_done = True
    with phase("backward"):
        loss.backward()
    bwd = {"knn": knn_cuda.launches, "scatter": scatter_cuda.launches}
    return pc, poses, d.grad, k.grad, {"forward": fwd, "backward": bwd}


# the kernel that each counted launch of a wrapper runs once
COUNTED_KERNELS = {"knn": "knn1_search", "scatter": "scatter_rows<"}


class PhaseTrace:
    """Device-only profiles (``torch.profiler``, no host op records) of a
    :func:`grad_step`'s phases, one session each: the device's busy seconds
    and events summed over the phases, the memory allocated at the end of
    the forward, and for each phase the launches of the port's kernels that
    the trace shows (``kernels``: ``knn1_search`` events for the 1-NN,
    ``scatter_rows<...>`` events for the scatter; a replayed graph's kernels
    are in the trace like any other), measured apart from the wrappers'
    counters. The trace can miss a few events of a long phase (PERF.md §7),
    so a count it shows is at most the launches made. Each session starts
    with a marker kernel (``torch.cuda._sleep``) and a synchronize, left out
    of the numbers.

    Given the pipeline ``slam``, the run of each recovery branch
    (``BRANCHES``, the names ``ICPSLAM._track`` runs them under eagerly;
    captured, they are conditional nodes of the frame's graphs, unmarked)
    is bracketed by a short marker kernel where
    it starts and ends in the forward, and where the gradient reaches a
    branch's pose and leaves it for the pose it started from (the branch's
    backward, with the remat recompute). The marks go around the run, never
    inside a body, which a capture would record. ``branch`` then holds, for
    each phase with marks, ``(the device seconds from the first mark to the
    last, the phase's device span, the marks)``: the phase split at its
    branches."""

    MARKER = "spin_kernel"
    MARK_NS = 10_000  # a branch's mark spins for under 10 us, the session's for more
    BRANCHES = ("relocalize", "anchor")  # the names ICPSLAM._track runs the branches under

    def __init__(self, slam=None):
        self.busy, self.events, self.forward_b, self.kernels = 0.0, 0, None, {}
        self.slam, self.branch = slam, {}

    @staticmethod
    def _mark(*_):
        torch.cuda._sleep(1)

    @contextlib.contextmanager
    def _marked(self):
        if self.slam is None:
            yield
            return
        real_runner = self.slam._runner

        def runner(*modes):
            real_run = real_runner(*modes)

            def run(name, body, args, options=()):
                if name not in self.BRANCHES:
                    return real_run(name, body, args, options)
                self._mark()
                out = real_run(name, body, args, options)
                if out[0].requires_grad:
                    out[0].register_hook(self._mark)
                    args[2].register_hook(self._mark)  # the pose the branch started from
                self._mark()
                return out
            return run

        self.slam._runner = runner
        try:
            yield
        finally:
            del self.slam._runner

    @contextlib.contextmanager
    def __call__(self, name: str):
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(100_000)
            torch.cuda.synchronize()
            with self._marked():
                yield
            torch.cuda.synchronize()
        if name == "forward":
            self.forward_b = torch.cuda.memory_allocated()
        events = [e for e in prof.profiler.kineto_results.events()
                  if e.device_type() == DeviceType.CUDA]
        # the branches' marks spin for one cycle, the session's for 100,000
        # (which the trace may not hold)
        marks = sorted((e.start_ns(), e.start_ns() + e.duration_ns()) for e in events
                       if self.MARKER in e.name() and e.duration_ns() < self.MARK_NS)
        device = [e for e in events if self.MARKER not in e.name()]
        spans = [(e.start_ns(), e.start_ns() + e.duration_ns()) for e in device]
        busy = union_s(spans, 1e-9)
        check_profile(f"grad {name} phase", busy, len(device))
        self.busy += busy
        self.events += len(device)
        self.kernels[name] = {k: sum(kernel in e.name() for e in device)
                              for k, kernel in COUNTED_KERNELS.items()}
        if len(marks) > 1:
            span = (max(b for _, b in spans) - min(a for a, _ in spans)) * 1e-9
            self.branch[name] = ((marks[-1][0] - marks[0][1]) * 1e-9, span, len(marks))


class GraphLedger:
    """What a pipeline's ``FrameGraphs`` (``slam.frame_graphs``) does while
    the ledger is active, by key name (``'armed'``, ``'track'``, ...), read
    from its ``by_key`` tallies: the graphs it captures (``captured``:
    every kind, frame, forward and backward), the seconds the captures take
    (``capture_s``) and its replays (``replays``: of any of the key's
    graphs, forward or backward); and the times a read grew a conditional
    body's store (``regrows``, ``FrameGraphs.regrows``: each such forward
    ran twice)."""

    KINDS = ("frame", "forward", "backward")

    def __init__(self, slam):
        self.graphs = slam.frame_graphs
        self.captured = collections.Counter()
        self.capture_s = collections.Counter()
        self.replays = collections.Counter()
        self.regrows = 0

    def _read(self) -> dict:
        return {name: dict(tally) for name, tally in self.graphs.by_key.items()}

    def __enter__(self):
        self._before = self._read()
        self._regrows = self.graphs.regrows
        return self

    def __exit__(self, *exc):
        for name, tally in self._read().items():
            was = self._before.get(name, {})
            self.captured[name] += sum(tally.get(k, 0) - was.get(k, 0) for k in self.KINDS)
            self.capture_s[name] += tally.get("capture_s", 0) - was.get("capture_s", 0)
            self.replays[name] += tally.get("replays", 0) - was.get("replays", 0)
        self.regrows += self.graphs.regrows - self._regrows


def graphs_by_key(frame_graphs) -> dict:
    """A pipeline's graphs by key name and kind (``frame``, ``forward``,
    ``backward``), from its ``by_key`` tallies."""
    out = {name: {k: tally[k] for k in GraphLedger.KINDS if tally[k]}
           for name, tally in sorted(frame_graphs.by_key.items())}
    return {name: kinds for name, kinds in out.items() if kinds}


def check_armed_graph(tag: str, ledgers: dict, tracked: int) -> None:
    """A captured no-grad armed run as one graph a frame (key ``'armed'``,
    its branches conditional nodes inside it): its graphs captured in the
    first call (``ledgers['first']``), replayed once on each of the
    ``tracked`` frames of every later call and captured no more there, and
    no other key's graph (gate, branch, fuse) captured or replayed."""
    first = ledgers["first"]
    later = {call: led for call, led in ledgers.items() if call != "first"}
    others = {k for led in ledgers.values() for k in (*led.captured, *led.replays)
              if k != "armed" and (led.captured[k] or led.replays[k])}
    if not first.captured["armed"] or others or any(
            (led.captured["armed"], led.replays["armed"]) != (0, tracked)
            for led in later.values()):
        raise AssertionError(
            f"{tag}: not one 'armed' graph replayed a frame ({tracked} frames; other keys "
            f"{sorted(others)}): " + "; ".join(
                f"{call} captured {led.captured['armed']} replayed {led.replays['armed']}"
                for call, led in ledgers.items()))


def check_armed_grad_graph(tag: str, ledgers: dict, tracked: int, reads: list,
                           regrows: list) -> None:
    """A captured armed gradient run with its branches decided on the
    device: each tracked frame one ``FrameGraphs.grad`` call of the key
    ``'armed'`` (with remat the no-grad frame graph forward and a graph of
    the recompute and its VJP backward; without, the forward captured with
    its residuals, each branch's in its store, and a graph of its VJP
    backward; the branches and their VJPs conditional nodes in them), so
    every step after the first ones (``ledgers['first']``) replays two
    ``'armed'`` graphs on each of the ``tracked`` frames and captures none,
    no other key's graph (gate, branch, fuse) is captured or replayed in
    any step, and each step reads back at most twice (``reads``, by step:
    after the forward's last frame and after the backward's), once more
    where its read grew a store (``regrows``, by step): at most once, in
    the first step."""
    first = ledgers["first"]
    later = {call: led for call, led in ledgers.items() if call != "first"}
    others = {k for led in ledgers.values() for k in (*led.captured, *led.replays)
              if k != "armed" and (led.captured[k] or led.replays[k])}
    if not first.captured["armed"] or others or any(
            (led.captured["armed"], led.replays["armed"]) != (0, 2 * tracked)
            for led in later.values()) or any(
            n > 2 + g for n, g in zip(reads, regrows)) or regrows[0] > 1 or any(regrows[1:]):
        raise AssertionError(
            f"{tag}: not one 'armed' graph pair replayed a frame ({tracked} frames; other keys "
            f"{sorted(others)}; reads by step {reads}, regrowths by step {regrows}): "
            + "; ".join(f"{call} captured {led.captured['armed']} replayed "
                        f"{led.replays['armed']}" for call, led in ledgers.items()))


class ReadBacks:
    """Counts the armed frame's host reads (``icpslam._read_back``: the
    gate's flags, or the predicates of a captured run) while active, by the
    tracked frame the pipeline ``slam`` was on (its health log's length
    + 1: ``L`` after the last frame)."""

    def __init__(self, slam):
        self.slam, self.reads = slam, collections.Counter()

    def __enter__(self):
        self._real = icpslam_module._read_back

        def read_back(flags):
            self.reads[len(self.slam.recovery_log["health"]) + 1] += 1
            return self._real(flags)

        icpslam_module._read_back = read_back
        return self

    def __exit__(self, *exc):
        icpslam_module._read_back = self._real


def decide_on_host(pred, body, args, outs):
    """:func:`graphs.when`'s decision made on the host (one read)."""
    return list(body(*args)) if bool(pred) else outs


def bits(t: torch.Tensor) -> torch.Tensor:
    """``t``'s bits as integers: NaN and -0.0 compare as written."""
    return t.detach().view(torch.int32) if t.dtype == torch.float32 else t.detach()


def conditional_grad_check(device: str = "cuda") -> str:
    """A differentiable :func:`graphs.when` through ``FrameGraphs.grad``
    with remat and without (the armed gradient step's design, on a toy
    body): the body's 1-NN search and scatter (forward), and its scatter's
    backward, inside conditionals decided on the device in the forward
    graph and in the backward graph (with remat the recompute and its VJP;
    without, the VJP, after its node copied the call's residuals back from
    the body's store). Six steps through one cache each, predicates true
    and false (warm-ups, captures, replays), each against the same body
    decided on the host, bit for bit: the outputs, the three inputs'
    gradients, the launches of the forward (twice in the step whose read
    grew the store, whose forward runs again) and of the backward phase
    (with remat the recompute's too), one read of the backward's
    predicates after it. Where the predicate is false the branch's input
    takes negative values, whose square roots (NaN) the body would keep
    as residuals: the gradients stay the pass-through's, finite. Without
    remat the store holds one call's residuals, pushed where the predicate
    held."""
    g = torch.Generator().manual_seed(0)
    B, N = 2, 4800
    tgt = torch.randn(B, 2 * N, 3, generator=g).to(device)
    dest = torch.stack([torch.randperm(2 * N, generator=g)[:N] for _ in range(B)]).to(device)
    x0 = (torch.rand(B, N, 3, generator=g) + 0.1).to(device)
    w0 = torch.randn(B, 1, 3, generator=g).to(device)
    t0 = torch.randn(B, 2 * N, 3, generator=g).to(device)

    def branch(x, w, table):
        d, _ = nn_points_auto(x.detach(), tgt)
        y = scatter_rows_into(table * 1.5, dest, torch.sqrt(x) * w)
        return [y * d[:, :1, None]]

    def body(x, w, table, gate, decide):
        y = decide(gate[0] > 0, branch, (x, w, table), [table * 2.0])[0]
        # every input used outside the branch too, as the armed frame's are
        return (y ** 2).sum((1, 2)) + (x * w).sum((1, 2))

    def step(run, gate, poisoned):
        x = (-x0 if poisoned else x0).clone().requires_grad_()
        w, table = w0.clone().requires_grad_(), t0.clone().requires_grad_()
        knn_cuda.launches = scatter_cuda.launches = 0
        out = run(x, w, table, gate)
        fwd = (knn_cuda.launches, scatter_cuda.launches)
        knn_cuda.launches = scatter_cuda.launches = 0
        out.sum().backward()
        bwd = (knn_cuda.launches, scatter_cuda.launches)
        return [bits(t) for t in (out, x.grad, w.grad, table.grad)], fwd, bwd

    reads, report = [], []

    def read(flags):
        reads.append(1)
        return flags.tolist()

    for remat in (True, False):
        graphs = graphs_module.FrameGraphs()

        def captured(x, w, table, gate):
            def once():
                out = graphs.grad("check_grad", lambda *a: body(*a, graphs_module.when),
                                  (x, w, table, gate), remat=remat, read=read)
                graphs.settle()  # the forward's predicates, as ICPSLAM.forward reads them
                return out
            out = once()
            return once() if graphs.regrew else out  # a store grew: the forward again

        seen = []
        for on, poisoned in ((1.0, False), (1.0, False), (0.0, True), (0.0, False),
                             (1.0, False), (0.0, True)):
            gate = torch.tensor([on], device=device)
            reads.clear()
            regrows = graphs.regrows
            got, fwd, bwd = step(captured, gate, poisoned)
            want, hfwd, hbwd = step(lambda *a: body(*a, decide_on_host), gate, poisoned)
            runs = 1 + graphs.regrows - regrows
            hfwd_runs = tuple(n * runs for n in hfwd)
            hbwd = tuple(f + b for f, b in zip(hfwd, hbwd)) if remat else hbwd
            same = [torch.equal(a, b) for a, b in zip(got, want)]
            finite = all(bool(torch.isfinite(t.view(torch.float32)).all()) for t in got[1:])
            if (not all(same) or not finite or fwd != hfwd_runs or bwd != hbwd
                    or len(reads) != 1):
                raise AssertionError(
                    f"differentiable conditional, remat {remat}, gate {on} poisoned {poisoned}: "
                    f"bits equal {same}, gradients finite {finite}, launches forward {fwd} "
                    f"(host {hfwd}, forwards run {runs}), backward {bwd} (host {hbwd}), "
                    f"backward reads {len(reads)}")
            seen.append((bool(on), fwd, bwd))
        if not remat and not (graphs.regrows == 1 and graphs.store_bytes() > 0):
            raise AssertionError(f"differentiable conditional without remat: regrowths "
                                 f"{graphs.regrows}, store {graphs.store_bytes()} B")
        report.append(f"remat {'on' if remat else 'off'}: graphs {graphs.counts()}, (predicate, "
                      f"forward launches, backward-phase launches) {seen}"
                      + ("" if remat else f", regrowths {graphs.regrows}, the body's store "
                         f"{graphs.store_bytes()} B (one call's residuals)"))
    knn_cuda.launches = scatter_cuda.launches = 0
    return (f"differentiable conditional nodes: six gradient steps through FrameGraphs.grad "
            f"with remat and six without, each bit-equal to the host's decisions (outputs and "
            f"the three gradients), one read of the backward's predicates a step; NaN residuals "
            f"of a false branch left out of the gradients; " + "; ".join(report))


def conditional_check() -> str:
    """The conditional nodes' route (``graphs.CONDITIONAL_ROUTE``) on the
    card: a body with two :func:`graphs.when` nodes, the second's predicate
    decided from what the first wrote, captured and replayed for each pair
    of predicates against the same body decided on the host, bit for bit,
    with ``settle``'s predicates and the 1-NN launches it adds. Returns a
    report with CUDA's, the driver's and torch's versions."""
    g = torch.Generator().manual_seed(0)
    src = torch.randn(1, 4800, 3, generator=g).cuda()
    tgt = torch.randn(1, 9600, 3, generator=g).cuda()

    def body(gate, decide):
        outs = [torch.zeros(1, device="cuda"), torch.zeros(1, dtype=torch.int64, device="cuda")]

        def branch(scale):
            d, idx = nn_points_auto(src * scale, tgt)
            return d.sum(-1), idx.to(torch.int64).sum(-1)

        outs = decide(gate[0] > 0, branch, (1.0,), outs)
        return decide((outs[0].sum() != 0) & (gate[1] > 0), branch, (2.0,), outs)

    graphs = graphs_module.FrameGraphs()
    seen = []
    for gates in ((1.0, 1.0), (1.0, 1.0), (0.0, 1.0), (1.0, 0.0), (0.0, 0.0)):
        gate = torch.tensor(gates, device="cuda")
        knn_cuda.launches = 0
        got = [t.clone() for t in graphs("check", lambda x: body(x, graphs_module.when), (gate,))]
        took, launches = graphs.settle(), knn_cuda.launches
        knn_cuda.launches = 0
        want = body(gate, decide_on_host)
        expect = [bool(gates[0]), bool(gates[0] and gates[1])]
        if (not all(torch.equal(a, b) for a, b in zip(got, want)) or took != [expect]
                or launches != knn_cuda.launches):
            raise AssertionError(f"conditional nodes, gates {gates}: predicates {took} (expected "
                                 f"{[expect]}), launches {launches} against {knn_cuda.launches}, "
                                 f"bits equal {[torch.equal(a, b) for a, b in zip(got, want)]}")
        seen.append(took[0])
    knn_cuda.launches = 0
    driver = subprocess.run(["nvidia-smi", "--query-gpu=driver_version", "--format=csv,noheader"],
                            capture_output=True, text=True).stdout.strip()
    return (f"conditional nodes: {graphs_module.CONDITIONAL_ROUTE} (torch {torch.__version__}'s "
            f"CUDAGraph.begin_capture_to_if_node: "
            f"{hasattr(torch.cuda.CUDAGraph, 'begin_capture_to_if_node')}), CUDA runtime "
            f"{torch.version.cuda}, driver {driver}: replays bit-equal to the host's decisions "
            f"with predicates {seen}, the 1-NN launches added where they read true")


class ScatterSpy:
    """Keeps the real inputs the scatter's dispatchers
    (``structures/pointclouds.py:_scatter_rows``, ``_scatter_rows_into``)
    get in one gradient step: in the forward, the last call of each kind (a
    fresh table by its size; a write into a buffer, which on a fusion path
    is the scatter merge), and in the backward the first buffer gradient of
    ``_ScatterRowsInto`` (the copy form on the output's gradient with zero
    values). The recompute's calls are not kept. ``check`` then holds the
    kernel against its plain version on those tensors, bit for bit."""

    def __init__(self):
        self.calls = {}
        self.forward_done = False
        self._in_backward = False

    def __enter__(self):
        pcm = pointclouds_module
        self._real = (pcm._scatter_rows, pcm._scatter_rows_into,
                      pcm._ScatterRowsInto.__dict__["backward"])
        rows, into, backward = self._real

        def spy_rows(size, dest, values, fill):
            if not self.forward_done:
                self.calls[f"forward table {size}"] = (size, dest, values, fill)
            return rows(size, dest, values, fill)

        def spy_into(buf, dest, values):
            if not self.forward_done:
                self.calls["forward into buffer"] = (buf, dest, values, None)
            elif self._in_backward and not (buf.requires_grad or values.requires_grad):
                # the buffer gradient; inside _ScatterRowsInto.backward the
                # saved dest's unpack runs the frame's recompute first, whose
                # merge writes values that need a gradient
                self.calls.setdefault("backward buffer gradient", (buf, dest, values, None))
            return into(buf, dest, values)

        def spy_backward(ctx, grad):
            self._in_backward = True
            try:
                return backward.__func__(ctx, grad)
            finally:
                self._in_backward = False

        pcm._scatter_rows, pcm._scatter_rows_into = spy_rows, spy_into
        pcm._ScatterRowsInto.backward = staticmethod(spy_backward)
        return self

    def __exit__(self, *exc):
        pcm = pointclouds_module
        pcm._scatter_rows, pcm._scatter_rows_into, pcm._ScatterRowsInto.backward = self._real

    @staticmethod
    def batch_distinct(table, dest, values):
        """The call with each batch row's ``dest`` rolled by its batch index
        and seeded random payloads of the same shapes and dtypes: the clips
        of ``synthetic_sequence`` share their depths and poses, so the real
        tensors repeat across the batch and would hide a batch offset."""
        gen = torch.Generator(device=dest.device).manual_seed(0)

        def rand_like(x):
            if x.dtype.is_floating_point:
                return torch.randn(x.shape, dtype=x.dtype, device=x.device, generator=gen)
            return torch.randint(0, 2 ** 31 - 1, x.shape, dtype=x.dtype, device=x.device,
                                 generator=gen)

        rolled = torch.stack([torch.roll(dest[b], b) for b in range(dest.shape[0])])
        return (table if isinstance(table, int) else rand_like(table)), rolled, rand_like(values)

    def check(self, tag: str) -> list:
        """Each kept call through the kernel and the plain version, compared
        as integer views, on the real tensors and on :meth:`batch_distinct`
        ones. Returns the kinds checked."""
        for kind, (table, dest, values, fill) in self.calls.items():
            for real in (True, False):
                t, d, v = (table, dest, values) if real else self.batch_distinct(table, dest, values)
                args = (t if isinstance(t, int) else t.contiguous(), d.contiguous(),
                        v.contiguous(), fill)
                k, p = scatter_kernel(*args), scatter_plain(t, d, v, fill)
                if not (k.dtype == p.dtype and torch.equal(int_view(k), int_view(p))):
                    raise AssertionError(f"grad {tag}: the scatter kernel differs from its plain "
                                         f"version on the step's {kind} "
                                         f"({'real' if real else 'batch-distinct'} tensors)")
        log(f"grad {tag}: the scatter kernel bit-equal to its plain version on the step's "
            "real and batch-distinct tensors: " + "; ".join(
                f"{kind} (dest {tuple(d.shape)} {d.dtype}, values {tuple(v.shape)} {v.dtype})"
                for kind, (_, d, v, _) in self.calls.items()))
        kinds = sorted(self.calls)
        self.calls = {}
        return kinds


def grad_small_phase() -> None:
    """(a) The four configurations on a small clip: the card's gradients
    against the CPU run of the same code within the CPU tests' bars, and
    remat on against off on the card: equal SHA-256 digests of the poses
    and map points, gradients within the same bars (``gather``'s backward
    adds with atomics on the card, so not bit for bit)."""
    for name, (kw, bar) in GRAD_SMALL_CONFIGS.items():
        out = {}
        for dev, remat in (("cpu", False), ("cuda", False), ("cuda", True)):
            slam = PointFusion(remat=remat, **kw)
            pc, poses, gd, gk, _ = grad_step(slam, grad_inputs(GRAD_SMALL, dev))
            out[dev, remat] = (sha256_of(poses, pc.points, pc.num_points),
                               gd.cpu().double(), gk.cpu().double())
        ref_d, ref_k = out["cpu", False][1:]
        gaps = {}
        for key in (("cuda", False), ("cuda", True)):
            gaps[key] = (float((out[key][1] - ref_d).abs().max() / ref_d.abs().max()),
                         float((out[key][2] - ref_k).abs().max() / ref_k.abs().max()))
        remat_gap = (float((out["cuda", True][1] - out["cuda", False][1]).abs().max()
                           / ref_d.abs().max()),
                     float((out["cuda", True][2] - out["cuda", False][2]).abs().max()
                           / ref_k.abs().max()))
        if out["cuda", True][0] != out["cuda", False][0]:
            raise AssertionError(f"grad small {name}: remat changed the forward on the card")
        if not (max(gaps["cuda", False]) <= bar and max(remat_gap) <= bar):
            raise AssertionError(f"grad small {name}: card vs CPU {gaps['cuda', False]}, "
                                 f"remat on vs off {remat_gap}, bar {bar}")
        log(f"grad small {name} {GRAD_SMALL}: card vs CPU max |dg| / max |g|: depth "
            f"{gaps['cuda', False][0]:.3e}, intrinsics {gaps['cuda', False][1]:.3e} (remat on: "
            f"{gaps['cuda', True][0]:.3e}, {gaps['cuda', True][1]:.3e}); remat on vs off: "
            f"forward digests equal ({out['cuda', True][0][:16]}), gradients {remat_gap[0]:.3e}, "
            f"{remat_gap[1]:.3e}; bar {bar:g}")


def grad_expect(name: str, remat: bool, log: dict, regrows: int = 0) -> dict:
    """A row's launches in the forward and the backward phase of a step
    whose branches ran on the frames of ``log`` (:func:`grad_launches`;
    with remat the backward phase adds the recompute; a step whose read
    grew a store, ``regrows``, ran its forward twice)."""
    fwd, bwd, rec = zip(*grad_launches(name, log).values())
    return {"forward": dict(zip(("knn", "scatter"), (n * (1 + regrows) for n in fwd))),
            "backward": {k: b + (r if remat else 0) for k, b, r in zip(("knn", "scatter"), bwd, rec)}}


def grad_digests(result) -> tuple:
    """SHA-256 digests of a step's ``(poses and map, depth gradient,
    intrinsics gradient)``."""
    pc, poses, gd, gk, _ = result
    return sha256_of(poses, pc.points, pc.num_points), sha256_of(gd), sha256_of(gk)


def rel_gap(a, b) -> float:
    """max |a - b| / max |b|."""
    return float((a - b).abs().max() / b.abs().max())


def grad_row(name: str, remat: bool):
    """A row's gradient steps with ``use_jit=False`` and then ``True``, a
    fresh pipeline each. Eager: a first step (its scatter inputs through
    the kernel and the plain version, :class:`ScatterSpy`) and a steady
    step. Captured: a
    first step (the warm-ups and the forward
    captures), a second (the backward captures of the warm-up frames'
    keys), a steady step (every frame's forward and backward replayed:
    armed, one ``'armed'`` graph pair a frame with its branches decided on
    the device and at most two reads a step, :func:`check_armed_grad_graph`)
    and a profiled one. The reads back of every step are counted
    (:class:`ReadBacks`), and the steps whose read grew a conditional
    body's store (``GraphLedger.regrows``: armed without remat, the first
    step, whose forward then runs twice). Every step's launches in the
    forward and the backward phase equal :func:`grad_launches`' for the
    frames its branches ran on (the forward's twice in a step that grew a
    store), and every step runs them on the first step's frames. Captured against
    eager: map, poses and depth gradients SHA-256-equal, the intrinsics
    gradient bit-equal or within ``GRAD_SUM_ORDER_BAR`` of its largest
    magnitude (the frames' contributions summed in another order); where
    the two eager steps' depth gradients differ (atomic adds on the card),
    the captured one within ``GRAD_SUM_ORDER_BAR`` too. The first captured
    step's results unchanged by the later steps, ``last_call_captured``
    True. Armed without remat, the stores' bytes after the steady step
    equal to what the branches that ran in it pushed, more than none.
    Reports s/step first and steady (host clock, ending in a
    synchronize), the steady step's peak memory, the profiled step's device
    busy time and events and its split at its branches
    (:class:`PhaseTrace`), graphs and capture s for both modes. Returns
    ``({mode: (g_depth, g_K)}, {mode: measurements})``."""
    shape, cap, kw, _ = GRAD_ROWS[name]
    tag = f"{name} remat={'on' if remat else 'off'}"
    inputs = row_inputs(name, "cuda")
    branches = None
    B, L = shape[:2]
    armed = kw.get("relocalize_below", 0) > 0
    rows, grads, results = {}, {}, {}
    for mode, use_jit in (("eager", False), ("captured", True)):
        slam = PointFusion(map_capacity=cap, remat=remat, use_jit=use_jit, **kw)
        # armed and captured: one graph pair a frame, the branches decided on
        # the device
        on_device = armed and armed_on_device(use_jit, True, remat)
        steps, secs, reads, regrows = [], [], [], []
        steady = 1 if mode == "eager" else 2  # the steady step's index
        profile = mode == "captured"
        trace, kept, ledgers = None, 0, {}
        for i in range(steady + 1 + profile):
            spy = ScatterSpy() if mode == "eager" and i == 0 else contextlib.nullcontext()
            ledger = ledgers.setdefault(
                "first" if i < steady else "steady" if i == steady else "profiled",
                GraphLedger(slam))
            if i > steady:  # the profiled step
                trace, kept = PhaseTrace(slam), slam.frame_graphs.kept_bytes
            torch.cuda.synchronize()
            if i == steady:
                torch.cuda.reset_peak_memory_stats()
                start = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            with spy, ledger, ReadBacks(slam) as read_backs:
                out = grad_step(slam, inputs, spy if isinstance(spy, ScatterSpy) else None,
                                trace or contextlib.nullcontext)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            reads.append(sum(read_backs.reads.values()))
            regrows.append(slam.frame_graphs.regrows - sum(regrows))
            if i == steady:
                peak = torch.cuda.max_memory_allocated()
                stores = (slam.frame_graphs.store_bytes(), slam.frame_graphs.pushed_bytes)
            expect = grad_expect(name, remat, slam.recovery_log, regrows[-1])
            branches = branches or branch_frames(slam)
            if out[4] != expect or branch_frames(slam) != branches:
                raise AssertionError(f"grad {tag} {mode} step {i}: launches {out[4]}, expected "
                                     f"{expect}; branches {branch_frames(slam)}, the first "
                                     f"step's {branches}")
            if slam.last_call_captured != use_jit:
                raise AssertionError(f"grad {tag} {mode}: last_call_captured "
                                     f"{slam.last_call_captured} ({slam.last_eager_reason})")
            if isinstance(spy, ScatterSpy):
                kinds = spy.check(tag)
                merge_kinds = {"forward into buffer", "backward buffer gradient"}
                if fusion_modes(name)[1] == "scatter" and not merge_kinds <= set(kinds):
                    raise AssertionError(f"grad {tag}: the scatter merge's calls were not seen: "
                                         f"{kinds}")
            steps.append((grad_digests(out), out[2].detach().clone(), out[3].detach().clone()))
            if i == 0:
                held = out
        if not tf32_disabled():
            raise AssertionError(f"grad {name}: TF32 was turned on during the step")
        if grad_digests(held) != steps[0][0]:
            raise AssertionError(f"grad {tag} {mode}: the first step's results changed in the "
                                 "later steps")
        kept = slam.frame_graphs.kept_bytes - kept
        # the trace may miss an event but never shows one more: a kernel
        # that a graph held twice would show here (one it lost would change
        # the results, held SHA-256-equal to eager's below)
        if trace is not None and any(trace.kernels[ph][k] > expect[ph][k]
                                     for ph in expect for k in expect[ph]):
            raise AssertionError(f"grad {tag} {mode} profiled step: the device trace's kernels "
                                 f"{trace.kernels}, expected at most {expect}")
        launches = out[4]
        if not use_jit:  # counted where the wrappers launch (a replay runs none)
            GRAD_LAUNCHES[tag] = launches
            LAUNCHES[f"grad_{name}_remat_{'on' if remat else 'off'}"] = {
                k: launches["forward"][k] + launches["backward"][k] for k in ("knn", "scatter")}
        graphs = slam.frame_graphs.counts()
        by_key = graphs_by_key(slam.frame_graphs)
        if on_device:
            check_armed_grad_graph(f"grad {tag}", ledgers, L - 1, reads, regrows)
        elif not use_jit and any(led.captured or led.replays for led in ledgers.values()):
            raise AssertionError(f"grad {tag} eager: graphs captured or replayed")
        stored = ""
        if on_device and not remat:
            if not stores[0] == stores[1] > 0:
                raise AssertionError(f"grad {tag}: the stores hold {stores[0]} B after the "
                                     f"steady step, whose branches pushed {stores[1]} B")
            stored = (f"; the conditional bodies' stores {stores[0]} B, what the steady "
                      f"step's branches pushed, regrowths by step {regrows}")
        results[mode] = steps
        grads[mode] = (out[2], out[3])
        counts = out[0].num_points
        gmax = (float(out[2].abs().max()), float(out[3].abs().max()))
        if not all(math.isfinite(g) and g > 0 for g in gmax):
            raise AssertionError(f"grad {tag} {mode}: max |g| depth, intrinsics {gmax}")
        points = int(out[0].num_points.sum())
        capture_s = slam.frame_graphs.capture_s
        del out, held
        memory = graph_memory(slam.frame_graphs)
        t = secs[steady]
        busy = trace and trace.busy
        rows[mode] = dict(first_s=secs[0], steady_s=t, peak_b=peak, start_b=start, reads=reads,
                          busy_s=busy, events=trace and trace.events,
                          branch=trace and trace.branch, graphs=graphs, capture_s=capture_s,
                          by_key=by_key, regrows=regrows, stores=stores if stored else None,
                          forward_b=trace and trace.forward_b, kept_b=kept, **memory)
        if trace is None:
            profiled = "; not profiled (PERF.md §6 holds the profiles of such steps)"
        else:
            profiled = (
                f"; the profiled step: device busy {busy:.4f} s ({100 * busy / t:.1f}% of the "
                f"steady step), {trace.events} device events, its device trace shows "
                f"{trace.kernels} ({'all' if trace.kernels == expect else 'not all'} of them)"
                + "".join(f"; its {ph} phase's device span {span:.4f} s, the branches' "
                          f"{part:.4f} s of it ({100 * part / span:.1f}%, {marks} marks)"
                          for ph, (part, span, marks) in trace.branch.items())
                + f"; allocated after its forward {trace.forward_b} B, its arenas {kept} B")
        log(f"grad {tag} {mode} {shape} capacity {cap}: first step {secs[0]:.4f} s, steady "
            f"{B * L / t:.4f} frames/s ({t:.4f} s a step), peak memory {peak} B ({peak - start} "
            f"B over the step's start), reads back by step {reads}"
            f"{' (the branches decided on the device)' if on_device else ''}{stored}, graphs "
            f"{graphs} captured in {capture_s:.4f} s (by key {by_key}), map "
            f"{points} points, max |g| depth {gmax[0]:.6e}, intrinsics {gmax[1]:.6e}; launches "
            f"in every step (counters): forward {launches['forward']}, backward phase "
            f"{launches['backward']}" + profiled + f"; memory: the forwards' saved tensors "
            f"{memory['saved_b']} B over the keys, resident in the graphs "
            f"{memory['resident_b']} B, pool reserved {memory['pool_b']} B")
        del slam
        gc.collect()  # a pipeline's autograd nodes and graphs free in cycles
    eager, captured = results["eager"], results["captured"]
    own = {mode: r["peak_b"] - r["start_b"] for mode, r in rows.items()}
    if own["captured"] > own["eager"] * (1 + GRAD_PEAK_SLACK):
        raise AssertionError(f"grad {tag}: the captured steady step's own peak {own['captured']} "
                             f"B is above eager's {own['eager']} B plus {GRAD_PEAK_SLACK:.0%}")
    if len({d[0][0] for d in eager + captured}) != 1:
        raise AssertionError(f"grad {tag}: map or poses differ between the modes or steps")
    eager_same = eager[0][0][1] == eager[1][0][1]
    eager_gap = rel_gap(eager[1][1], eager[0][1])
    for i, (dig, gd, gk) in enumerate(captured):
        depth_gap, k_gap = rel_gap(gd, eager[0][1]), rel_gap(gk, eager[0][2])
        if eager_same and dig[1] != eager[0][0][1]:
            raise AssertionError(f"grad {tag}: captured step {i}'s depth gradient is not the "
                                 f"eager bits (gap {depth_gap:.3e} of max |g|)")
        if not (depth_gap <= GRAD_SUM_ORDER_BAR and k_gap <= GRAD_SUM_ORDER_BAR):
            raise AssertionError(f"grad {tag}: captured step {i} against eager: depth "
                                 f"{depth_gap:.3e}, intrinsics {k_gap:.3e} of max |g|")
    k_same = all(dig[2] == eager[0][0][2] for dig, _, _ in captured)
    log(f"grad {tag}: captured against eager: map and poses SHA-256-equal "
        f"({eager[0][0][0][:16]}); depth gradient "
        + ("SHA-256-equal" if eager_same else
           f"within {max(rel_gap(gd, eager[0][1]) for _, gd, _ in captured):.3e} of max |g| "
           f"(the two eager steps differ by {eager_gap:.3e}: atomic adds)")
        + "; intrinsics gradient " + ("SHA-256-equal" if k_same else
           f"within {max(rel_gap(gk, eager[0][2]) for _, _, gk in captured):.3e} of max |g| "
           "(the frames' contributions summed in another order)")
        + f"; launches {expect} in every step of both modes, the branches at {branches} in "
        "each; the first step's results unchanged by the later steps")
    if name in GRAD_CPU_ROWS:
        check_row_against_cpu(name, tag, counts, grads)
    return grads, rows


# (f) the online calls under grad, as the JAX package jits ``_step`` under
# jax.grad: the step loop (``step_loop``, at ``ONLINE_CAP``) on the easy
# 640x480 clip, remat on; name -> pipeline options
ONLINE_GRAD_SHAPE = (1, 10, 480, 640)  # 10 of the clip's 30 frames: the script's time limit
ONLINE_GRAD_ROWS = {"gt": dict(odom="gt"), "knn": GRADICP}


def online_grad_step(slam, inputs):
    """One gradient step through the online API: the step loop, then
    ``sum(points^2)`` of its last map (tracked: plus ``sum(t^2)`` of the
    returned poses) backward to the depth images and the intrinsics. Both
    kernels' counts from 0 in the loop and in the backward, as
    :func:`grad_step`. Returns ``(pointclouds, poses, g_depth, g_K,
    launches)``."""
    rgb, depth, K, P = inputs
    d = depth.clone().requires_grad_()
    k = K.clone().requires_grad_()
    knn_cuda.launches = scatter_cuda.launches = 0
    pc, poses = step_loop(slam, RGBDImages(rgb, d, k, P), cv=False)
    loss = (pc.points ** 2).sum()
    if slam.odom != "gt":
        loss = loss + (poses[..., :3, 3] ** 2).sum()
    fwd = {"knn": knn_cuda.launches, "scatter": scatter_cuda.launches}
    knn_cuda.launches = scatter_cuda.launches = 0
    loss.backward()
    bwd = {"knn": knn_cuda.launches, "scatter": scatter_cuda.launches}
    return pc, poses, d.grad, k.grad, {"forward": fwd, "backward": bwd}


def online_grad_row(name: str) -> dict:
    """An ``ONLINE_GRAD_ROWS`` row's gradient steps through the step loop
    with ``use_jit=False`` (two steps) and then ``True`` (three: the first
    warms up and captures each call's forward and the first backwards, the
    second the rest of the backwards, the third replays every call's
    forward and backward), a fresh pipeline each, then a profiled captured
    step. Every step of both modes launches the same counts in the loop and
    in the backward (the captured ones added up by the counters on replay;
    the profiled step's device trace shows no more). Captured against
    eager: map and poses SHA-256-equal, the depth gradient SHA-256-equal
    where the two eager steps agree, else and for the intrinsics within
    ``GRAD_SUM_ORDER_BAR`` of max |g|; the first step's results unchanged by
    the later steps; every step's calls captured. Returns the
    measurements by mode."""
    kw = ONLINE_GRAD_ROWS[name]
    inputs = grad_inputs(ONLINE_GRAD_SHAPE, "cuda")
    rows, results = {}, {}
    for mode, use_jit in (("eager", False), ("captured", True)):
        slam = PointFusion(map_capacity=ONLINE_CAP, remat=True, use_jit=use_jit, **kw)
        steps, secs = [], []
        for i in range(2 if mode == "eager" else 3):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = online_grad_step(slam, inputs)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            if slam.last_call_captured != use_jit:
                raise AssertionError(f"online grad {name} {mode}: last_call_captured "
                                     f"{slam.last_call_captured} ({slam.last_eager_reason})")
            steps.append((grad_digests(out), out[2].detach().clone(), out[3].detach().clone(),
                          out[4]))
            if i == 0:
                held = out
        peak = torch.cuda.max_memory_allocated()
        if grad_digests(held) != steps[0][0]:
            raise AssertionError(f"online grad {name} {mode}: the first step's results changed "
                                 "in the later steps")
        launches = steps[0][3]
        if any(step[3] != launches for step in steps):
            raise AssertionError(f"online grad {name} {mode}: launches {[s[3] for s in steps]}")
        total = {k: launches["forward"][k] + launches["backward"][k] for k in ("knn", "scatter")}
        busy = events = None
        if use_jit:
            CAPTURED_LAUNCHES[f"online_grad_{name}"] = total
            trace = device_profile(lambda: online_grad_step(slam, inputs))
            if any(trace["kernels"][k] > total[k] for k in total):
                raise AssertionError(f"online grad {name}: the profiled step's device trace "
                                     f"shows {trace['kernels']}, more than the {total} counted")
            busy, events = trace["busy_s"], trace["events"]
        else:
            GRAD_LAUNCHES[f"online {name} remat=on"] = launches
            LAUNCHES[f"online_grad_{name}"] = total
        gmax = (float(out[2].abs().max()), float(out[3].abs().max()))
        if not all(math.isfinite(g) and g > 0 for g in gmax):
            raise AssertionError(f"online grad {name} {mode}: max |g| depth, intrinsics {gmax}")
        rows[mode] = dict(first_s=secs[0], steady_s=secs[-1], peak_b=peak, busy_s=busy,
                          events=events, graphs=slam.frame_graphs.counts(),
                          capture_s=slam.frame_graphs.capture_s, launches=launches, gmax=gmax,
                          points=int(out[0].num_points.sum()))
        results[mode] = steps
        del out, held, slam
        gc.collect()  # a pipeline's autograd nodes and graphs free in cycles
    eager, captured = results["eager"], results["captured"]
    if rows["captured"]["launches"] != rows["eager"]["launches"]:
        raise AssertionError(f"online grad {name}: launches captured "
                             f"{rows['captured']['launches']}, eager {rows['eager']['launches']}")
    if len({d[0][0] for d in eager + captured}) != 1:
        raise AssertionError(f"online grad {name}: map or poses differ between the modes or steps")
    eager_same = eager[0][0][1] == eager[1][0][1]
    gaps = []
    for i, (dig, gd, gk, _) in enumerate(captured):
        depth_gap, k_gap = rel_gap(gd, eager[0][1]), rel_gap(gk, eager[0][2])
        gaps.append((depth_gap, k_gap))
        if eager_same and dig[1] != eager[0][0][1]:
            raise AssertionError(f"online grad {name}: captured step {i}'s depth gradient is not "
                                 f"the eager bits (gap {depth_gap:.3e} of max |g|)")
        if not (depth_gap <= GRAD_SUM_ORDER_BAR and k_gap <= GRAD_SUM_ORDER_BAR):
            raise AssertionError(f"online grad {name}: captured step {i} against eager: depth "
                                 f"{depth_gap:.3e}, intrinsics {k_gap:.3e} of max |g|")
    k_same = all(dig[2] == eager[0][0][2] for dig, _, _, _ in captured)
    r_e, r_c = rows["eager"], rows["captured"]
    log(f"online grad {name} step loop {ONLINE_GRAD_SHAPE} at {ONLINE_CAP} rows, remat on: "
        f"captured against eager: map and poses SHA-256-equal ({eager[0][0][0][:16]}, map "
        f"{r_c['points']}); depth gradient "
        + ("SHA-256-equal" if eager_same else
           f"within {max(g[0] for g in gaps):.3e} of max |g| (the two eager steps differ by "
           f"{rel_gap(eager[1][1], eager[0][1]):.3e}: atomic adds)")
        + "; intrinsics gradient " + ("SHA-256-equal" if k_same else
                                      f"within {max(g[1] for g in gaps):.3e} of max |g|")
        + f"; launches {r_e['launches']} in every step of both modes; s/step eager first "
        f"{r_e['first_s']:.4f}, steady {r_e['steady_s']:.4f}; captured first "
        f"{r_c['first_s']:.4f}, steady {r_c['steady_s']:.4f} "
        f"({r_e['steady_s'] / r_c['steady_s']:.2f}x), the profiled step's device busy "
        f"{r_c['busy_s']:.4f} s ({100 * r_c['busy_s'] / r_c['steady_s']:.1f}% of the steady "
        f"step), {r_c['events']} device events; graphs {r_c['graphs']} captured in "
        f"{r_c['capture_s']:.4f} s; the steady step's peak memory eager {r_e['peak_b']} B, "
        f"captured {r_c['peak_b']} B; max |g| depth {r_c['gmax'][0]:.6e}, intrinsics "
        f"{r_c['gmax'][1]:.6e}")
    return rows


def graph_memory(frame_graphs) -> dict:
    """What a pipeline's graphs hold, read before they are freed:
    ``saved_b``, the storages their captured forwards keep saved tensors in
    (:meth:`FrameGraphs.saved_bytes`); ``pool_b``, the bytes reserved in
    their pool's segments (``torch.cuda.memory_snapshot``; None where the
    snapshot does not name pools); ``resident_b``, the bytes allocated that
    clearing them frees (their static inputs and outputs, saved tensors and
    the backwards' buffers). Clears them."""
    pool = frame_graphs._pool
    pool_b = None
    segments = torch.cuda.memory_snapshot() if pool is not None else []
    if segments and "segment_pool_id" in segments[0]:
        pool_b = sum(seg["total_size"] for seg in segments
                     if tuple(seg["segment_pool_id"]) == tuple(pool))
    saved_b = frame_graphs.saved_bytes()
    gc.collect()
    before = torch.cuda.memory_allocated()
    frame_graphs.clear()
    gc.collect()
    return dict(saved_b=saved_b, pool_b=pool_b,
                resident_b=before - torch.cuda.memory_allocated())


def gradient_gaps(gd, gk, ref: dict) -> dict:
    """Card gradients against a reference's: the intrinsics gradient
    relative to its largest magnitude; the depth gradient's sum (relative
    to its absolute sum), absolute sum and largest magnitude; at the
    reference's pixels (flat indices ``pix``, values ``at``), the 99th
    percentile of the gap, the share of pixels more than 1e-3 of the
    largest magnitude off, and the worst pixel, all relative to that
    magnitude. ``ref`` holds ``grad_K``, ``sum``, ``abssum``, ``maxabs``,
    ``pix`` and ``at``."""
    g = gd.detach().double().cpu().numpy()
    gk_ref = np.asarray(ref["grad_K"], dtype=np.float64)
    gap_at = np.abs(g.reshape(-1)[ref["pix"]] - np.asarray(ref["at"], dtype=np.float64))
    scale, abssum = float(ref["maxabs"]), float(ref["abssum"])
    return {
        "intrinsics": float(np.abs(gk.detach().double().cpu().numpy() - gk_ref).max()
                            / np.abs(gk_ref).max()),
        "sum": abs(float(g.sum()) - float(ref["sum"])) / abssum,
        "abssum": abs(float(np.abs(g).sum()) / abssum - 1.0),
        "maxabs": abs(float(np.abs(g).max()) / scale - 1.0),
        "pixels_p99": float(np.quantile(gap_at, 0.99) / scale),
        "pixels_over_1e-3": float(np.mean(gap_at > 1e-3 * scale)),
        "pixels_worst": float(gap_at.max() / scale),
    }


def golden_ref(golden, key: str) -> dict:
    """A golden row of ``GRAD_GOLDEN`` as a :func:`gradient_gaps` reference."""
    return {k: golden[f"{key}_{n}"] for k, n in (
        ("grad_K", "grad_K"), ("sum", "grad_depth_sum"), ("abssum", "grad_depth_abssum"),
        ("maxabs", "grad_depth_maxabs"), ("pix", "pix"), ("at", "grad_depth_at"))}


def full_ref(gd, gk) -> dict:
    """Whole gradients as a :func:`gradient_gaps` reference at every pixel."""
    g = gd.detach().double().cpu().numpy()
    return {"grad_K": gk.detach().cpu().numpy(), "sum": g.sum(), "abssum": np.abs(g).sum(),
            "maxabs": np.abs(g).max(), "pix": np.arange(g.size), "at": g.reshape(-1)}


def hold_gaps(what: str, gaps: dict, bars: dict) -> None:
    """Raises if a gap is above its bar; a bar of None only reports."""
    bad = {k: v for k, v in gaps.items() if bars[k] is not None and not v <= bars[k]}
    log(f"grad {what}: " + ", ".join(
        f"{k} {v:.3e} ({'reported' if bars[k] is None else f'bar {bars[k]:g}'})"
        for k, v in gaps.items()))
    if bad:
        raise AssertionError(f"grad {what}: above the bars: {bad}")


def check_row_against_cpu(name: str, tag: str, counts, grads: dict) -> None:
    """A row's card gradients (``{mode: (g_depth, g_K)}``) against the CPU
    run of the same code (remat off) at every pixel (bars
    ``GRAD_CPU_BARS``), and each clip's map count within
    ``GRAD_CPU_COUNT_REL`` of the CPU's."""
    shape, cap, kw, _ = GRAD_ROWS[name]
    t0 = time.perf_counter()
    pc, _, cd, ck, _ = grad_step(PointFusion(map_capacity=cap, **kw), grad_inputs(shape, "cpu"))
    ref = full_ref(cd, ck)
    card_n, cpu_n = counts.cpu().numpy(), pc.num_points.numpy()
    rel = np.abs(card_n - cpu_n) / cpu_n
    if not rel.max() <= GRAD_CPU_COUNT_REL:
        raise AssertionError(f"grad {tag}: map counts {card_n} on the card, {cpu_n} on the CPU")
    log(f"grad {tag}: map counts card {card_n.tolist()}, CPU {cpu_n.tolist()} "
        f"(CPU step {time.perf_counter() - t0:.2f} s)")
    for mode, (gd, gk) in grads.items():
        hold_gaps(f"{tag} {mode} against the CPU run of the same code, every pixel",
                  gradient_gaps(gd, gk, ref), GRAD_CPU_BARS)


def check_grad_golden(key: str, gd, gk, mode: str = "eager") -> None:
    """(c) A row's card gradients against the JAX package's CPU run
    (``tests/port/make_grad_golden.py``) at its 4,096 pixels
    (:func:`gradient_gaps`). Bars ``GRAD_GOLDEN_BARS``."""
    hold_gaps(f"golden {key} ({GRAD_GOLDEN_ROWS[key]} remat=on, {mode}) against the JAX CPU run",
              gradient_gaps(gd, gk, golden_ref(np.load(GRAD_GOLDEN), key)),
              GRAD_GOLDEN_BARS[key])


def chamfer_agrees_with_cpu(device: str = "cuda") -> None:
    """``chamfer_distance`` (squared, as the example's loss) on the card
    against the CPU on the same clouds, made on the CPU: the small clip's
    gt map against the gt map of its depths scaled by the example's 1.08
    (B=2). Value and gradients to both clouds within ``EXAMPLE_CHAMFER_BAR``
    of the CPU's largest, with both directions' 1-NN searches on the
    kernel."""
    rgb, depth, K, P = grad_inputs(GRAD_SMALL, "cpu")
    with torch.no_grad():
        maps = [PointFusion(odom="gt")(RGBDImages(rgb, depth * s, K, P))[0] for s in (1.0, 1.08)]
    out = {}
    for dev in ("cpu", device):
        a, b = (m.points.detach().to(dev).requires_grad_() for m in maps)
        knn_cuda.launches = 0
        value = chamfer_distance(a, b, maps[0].nonpad_mask.to(dev), maps[1].nonpad_mask.to(dev),
                                 squared=True)
        launches = knn_cuda.launches
        value.sum().backward()
        out[dev] = (value.detach().double().cpu(), a.grad.double().cpu(), b.grad.double().cpu())
    if launches != 2:
        raise AssertionError(f"chamfer on the card launched the 1-NN {launches} times, not 2")
    gaps = [float((c - r).abs().max() / r.abs().max()) for c, r in zip(out[device], out["cpu"])]
    if not max(gaps) <= EXAMPLE_CHAMFER_BAR:
        raise AssertionError(f"chamfer card vs CPU {gaps}, bar {EXAMPLE_CHAMFER_BAR}")
    log(f"chamfer_distance {tuple(maps[0].points.shape)} against {tuple(maps[1].points.shape)}, "
        f"card vs CPU (max |d| / max |CPU|): value {gaps[0]:.3e} ({out['cpu'][0].tolist()}), "
        f"gradients {gaps[1]:.3e}, {gaps[2]:.3e}; bar {EXAMPLE_CHAMFER_BAR:g}; 1-NN launches 2")


def example_refines_on_the_card(device: str = "cuda") -> None:
    """``gradslam_torch.examples.gradient_refinement.refine`` on the card at
    the CPU test's settings (``EXAMPLE_REFINE``) and bars: the chamfer loss
    below 2% of its start, depth scale within 0.02 and focal within 0.03 of
    1. Launches, from the code: the 1-NN twice a step (the chamfer's two
    directions), the scatter twice a frame (sort_full + gather fusion) in
    the reference run and in every step's forward, none in a backward. The
    pipeline ``refine`` keeps across its steps runs them captured: after
    the first two steps (the warm-ups and captures) every frame's forward
    and backward replays, at least ``2 * L`` replays a step."""
    s = EXAMPLE_REFINE
    made = []
    real_init = PointFusion.__init__

    def init(self, *args, **kwargs):
        real_init(self, *args, **kwargs)
        made.append(self)

    knn_cuda.launches = scatter_cuda.launches = 0
    t0 = time.perf_counter()
    PointFusion.__init__ = init
    try:
        losses, rec_depth, rec_focal = gradient_refinement.refine(**s, verbose=False,
                                                                  device=device)
    finally:
        PointFusion.__init__ = real_init
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {"knn": knn_cuda.launches, "scatter": scatter_cuda.launches}
    expect = {"knn": 2 * s["steps"], "scatter": 2 * s["L"] * (s["steps"] + 1)}
    if launches != expect:
        raise AssertionError(f"example refine: launches {launches}, expected {expect}")
    LAUNCHES["grad_example_refine"] = launches
    if not (losses[-1] < 0.02 * losses[0] and abs(rec_depth - 1.0) < 0.02
            and abs(rec_focal - 1.0) < 0.03):
        raise AssertionError(f"example refine: loss {losses[0]} -> {losses[-1]}, "
                             f"depth scale {rec_depth}, focal {rec_focal}")
    (slam,) = made
    graphs = slam.frame_graphs
    if not (slam.last_call_captured and graphs.replays >= 2 * s["L"] * (s["steps"] - 2)):
        raise AssertionError(f"example refine: captured {slam.last_call_captured} "
                             f"({slam.last_eager_reason}), {graphs.replays} replays")
    log(f"example refine on the card {s}: loss {losses[0]:.6e} -> {losses[-1]:.6e}, recovered "
        f"depth scale {rec_depth:.6f}, focal {rec_focal:.6f} (bars 0.02, 0.03); "
        f"{secs:.2f} s; launches {launches}; captured: graphs {graphs.counts()}, "
        f"{graphs.replays} replays, capture {graphs.capture_s:.4f} s")


def grad_phase() -> None:
    """The differentiability slice: (a) card against CPU and remat on
    against off on a small clip, ``chamfer_distance`` card against CPU and
    the gradient example on the card (its steps replayed); (b) the bench_all
    rows at full width, eager and captured; (c) two rows against the JAX
    package's CPU gradients, both modes; (d) a profile of one gradient step
    (gt 640x480x30, remat on), eager and captured; (e) the armed rows
    (``ARMED_GRAD_ROWS``, the last of (b)'s rows, remat off and on), eager
    and captured; (f)
    the online step loop under grad (``ONLINE_GRAD_ROWS``), eager and
    captured."""
    disable_tf32()
    if not tf32_disabled():
        raise AssertionError("TF32 is enabled before the gradient phase")
    t0 = time.perf_counter()
    grad_small_phase()
    chamfer_agrees_with_cpu()
    example_refines_on_the_card()
    log(f"grad small phase: {time.perf_counter() - t0:.2f} s")
    peaks = {}
    for name, (_, _, _, remats) in GRAD_ROWS.items():
        for remat in remats:
            t_row = time.perf_counter()
            grads, rows = grad_row(name, remat)
            peaks[name, remat] = {mode: r["peak_b"] for mode, r in rows.items()}
            for key, row in GRAD_GOLDEN_ROWS.items():
                if row == name and remat:
                    for mode, (gd, gk) in grads.items():
                        check_grad_golden(key, gd, gk, mode)
            if name == "gt_640x480x30" and remat:
                gt_remat_secs = {mode: r["steady_s"] for mode, r in rows.items()}
            del grads
            torch.cuda.empty_cache()
            log(f"grad {name} remat={'on' if remat else 'off'}: "
                f"{time.perf_counter() - t_row:.2f} s for the row's checks")
    for mode in ("eager", "captured"):
        off, on = peaks["gt_640x480x30", False][mode], peaks["gt_640x480x30", True][mode]
        if not on < off:
            raise AssertionError(f"grad gt_640x480x30 {mode}: remat peak {on} B not below {off} B")
        log(f"grad gt_640x480x30 {mode}: peak memory remat on {on} B, off {off} B "
            f"({on / off:.3f}x)")
    shape, cap, kw, _ = GRAD_ROWS["gt_640x480x30"]
    inputs = grad_inputs(shape, "cuda")
    for mode, use_jit in (("eager", False), ("captured", True)):
        slam = PointFusion(map_capacity=cap, remat=True, use_jit=use_jit, **kw)
        for _ in range(2):  # captured: the second step captures the last backwards
            grad_step(slam, inputs)
        profile_run(lambda: grad_step(slam, inputs), f"grad gt 640x480x30 remat {mode}",
                    gt_remat_secs[mode])
    del slam, inputs
    gc.collect()
    for name in ONLINE_GRAD_ROWS:
        t_row = time.perf_counter()
        online_grad_row(name)
        torch.cuda.empty_cache()
        log(f"online grad {name}: {time.perf_counter() - t_row:.2f} s for the row's checks")


# --------------------------------------------------------------------------
# Tracking recovery, sub-pixel association and point rows, the large map
# --------------------------------------------------------------------------
RECOVERY_GOLDEN = Path(__file__).resolve().parent / "tests/port/data/recovery_jax_cpu.npz"
LARGE_GOLDEN = Path(__file__).resolve().parent / "tests/port/data/large_map_jax_cpu.npz"
LOCKSTEP_BAR = 2e-4  # each frame's step from the CPU run's state (as phase 8)


def fusion_scatters(cap: int, H: int, W: int, kw: dict) -> int:
    """Scatter launches of one PointFusion map update: the winner table and
    the write-back (row inversion or scatter merge, with user feature
    channels one more for the features buffer), and the window's compaction
    when the association is windowed (``'auto'`` resolved by
    ``fusionutils._resolve_modes``)."""
    window = min(kw.get("active_capacity") or 2 * H * W, cap)
    association, merge = _resolve_modes(kw.get("association", "auto"), kw.get("merge", "auto"),
                                        cap, H * W, window)
    # a map with user channels writes its features buffer in one more scatter
    # under the scatter merge
    features = 1 if merge == "scatter" and kw.get("feature_channels") else 0
    return (3 if association == "windowed" else 2) + features


def recovery_launches(kw: dict, shape: tuple, log: dict) -> dict:
    """Both kernels' launches of one PointFusion run with options ``kw`` on
    a clip of ``shape`` (B, L, H, W), derived from the code, given the
    frames on which the run's recovery branches ran (its ``recovery_log``):

    - fusion: :func:`fusion_scatters` a frame, at the capacity in force;
    - a tracked frame: each pyramid level's map window (points, normals: 2;
      a nested pyramid compacts once at the finest stride and once a
      coarser level instead), a 1-NN level's frame downsample (3) and its
      searches (two an iteration with the 'fresh' lookahead, one with
      'reuse');
    - armed: the gate, at the finest level's association (1-NN: the frame
      downsample 3 and one search; projective: none);
    - a relocalization: the full health before and after (1-NN: 3 + 2 and
      one search; projective: 2), and for each of the K hypotheses the map
      window 2, the frame 3, ``2 * relocalize_numiters`` searches and its
      1-NN score (3 + 2, one search);
    - the anchor: the snapshot (frame 3, two compactions) at frame 0 and at
      each refresh (frames ``f % anchor_every == 0`` that are not
      drifting); a re-solve: the frame 3 and ``2 * relocalize_numiters``
      searches.
    """
    _, L, H, W = shape
    sched = kw["map_capacity"]
    caps = ([c for n, c in sched for _ in range(n)] if isinstance(sched, list) else [sched] * L)
    scatter = sum(fusion_scatters(c, H, W, kw) for c in caps)
    if kw["odom"] == "gt":
        return {"knn": 0, "scatter": scatter}
    pyramid = kw.get("pyramid") or [(kw.get("dsratio", 4), kw.get("numiters", 20))]
    assoc = kw.get("odom_assoc", "knn")
    assocs = list(assoc) if isinstance(assoc, (list, tuple)) else [assoc] * len(pyramid)
    per_iter = 2 if kw.get("lookahead_assoc", "fresh") == "fresh" else 1
    nested = len(pyramid) > 1 and all(d % pyramid[-1][0] == 0 for d, _ in pyramid)
    knn_frame, scatter_frame = 0, len(pyramid) if nested else 0
    for (_, n), a in zip(pyramid, assocs):
        scatter_frame += 0 if nested else 2
        if a == "knn":
            scatter_frame += 3
            knn_frame += per_iter * n
    T = L - 1
    knn, scatter = knn_frame * T, scatter + scatter_frame * T
    if kw.get("relocalize_below", 0) > 0:
        finest_knn = assocs[-1] == "knn"
        knn += T if finest_knn else 0
        scatter += 3 * T if finest_knn else 0
        grid = kw.get("relocalize_grid") or {}
        K = len(grid.get("yaw_deg", (0.0, -15.0, 15.0, -30.0, 30.0))) * len(
            grid.get("translations", ((0.0, 0.0, 0.0),)))
        iters = kw.get("relocalize_numiters", 12)
        n_rel = len(log["relocalize"])
        knn += n_rel * ((2 if finest_knn else 0) + K * (2 * iters + 1))
        scatter += n_rel * ((10 if finest_knn else 4) + 10 * K)
        every = kw.get("anchor_every", 0)
        if every:
            refreshes = [f for f in range(1, L) if f % every == 0 and f not in log["anchor"]]
            scatter += 5 * (1 + len(refreshes)) + 3 * len(log["anchor"])
            knn += 2 * iters * len(log["anchor"])
    return {"knn": knn, "scatter": scatter}


def counted_run(slam, frames, path: str, kw: dict, shape: tuple, store: dict = LAUNCHES):
    """One run of ``path`` with both kernels' counts set to 0 just before it
    and read just after into ``store[path]``, held against
    :func:`recovery_launches`. Returns ``(pointclouds, poses, seconds)``."""
    torch.cuda.synchronize()
    knn_cuda.launches = 0
    scatter_cuda.launches = 0
    t0 = time.perf_counter()
    pc, poses = slam(frames)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    store[path] = {"knn": knn_cuda.launches, "scatter": scatter_cuda.launches}
    expect = recovery_launches(kw, shape, slam.recovery_log)
    if store[path] != expect:
        raise AssertionError(f"{path}: launches {store[path]}, expected {expect} "
                             f"(branches: {branch_frames(slam)})")
    return pc, poses, secs


def warm_and_time(slam, frames, path: str, kw: dict, shape: tuple, runs: int = 1):
    """A warm-up run, then ``runs`` counted runs. Returns the last result,
    the mean seconds a run and the peak device memory."""
    slam(frames)
    secs = []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(runs):
        pc, poses, s = counted_run(slam, frames, path, kw, shape)
        secs.append(s)
    return pc, poses, float(np.mean(secs)), torch.cuda.max_memory_allocated()


def branch_frames(slam) -> dict:
    return {k: slam.recovery_log[k] for k in ("relocalize", "anchor")}


def check_run(pc, poses, shape: tuple, tag: str) -> int:
    """No point dropped, finite map and poses of ``shape``; returns the map
    count."""
    B_, L_ = shape[:2]
    n = int(pc.num_points[0])
    if int(pc.num_dropped[0]) != 0:
        raise AssertionError(f"{tag}: {int(pc.num_dropped[0])} points dropped")
    for name in ("points", "normals", "colors", "features"):
        buf = getattr(pc, name)
        if buf is not None and not bool(torch.isfinite(buf[0, :n]).all()):
            raise AssertionError(f"{tag}: non-finite map {name}")
    if tuple(poses.shape) != (B_, L_, 4, 4) or not bool(torch.isfinite(poses).all()):
        raise AssertionError(f"{tag}: bad poses {tuple(poses.shape)}")
    return n


def map_digest(pc, poses) -> str:
    return sha256_of(poses, pc.points, pc.normals, pc.num_points,
                     *(b for b in (pc.colors, pc.features) if b is not None))


class KnnCapture:
    """Keeps the inputs of the first 1-NN kernel call made through the
    dispatcher while it is active (the kernel still runs)."""

    def __init__(self):
        self.args = None

    def __enter__(self):
        import gradslam_torch.ops as ops

        self._real = ops.nn_points_cuda

        def spy(src, tgt, mask=None):
            if self.args is None:
                self.args = (src, tgt, mask)
            return self._real(src, tgt, mask)

        ops.nn_points_cuda = spy
        return self

    def __exit__(self, *exc):
        import gradslam_torch.ops as ops

        ops.nn_points_cuda = self._real


class ScatterCapture:
    """Keeps the last new-table scatter call of each table size made while
    it is active (the kernel still runs): after a run, the last frame's."""

    def __init__(self):
        self.calls = {}

    def __enter__(self):
        self._real = pointclouds_module._scatter_rows

        def spy(size, dest, values, fill):
            self.calls[size] = (size, dest, values, fill)
            return self._real(size, dest, values, fill)

        pointclouds_module._scatter_rows = spy
        return self

    def __exit__(self, *exc):
        pointclouds_module._scatter_rows = self._real


def to_device(x, device):
    if x is None:
        return None
    if isinstance(x, tuple):
        return tuple(t.to(device) for t in x)
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return pointclouds_to(x, device)


def lockstep(kw: dict, arrays: tuple, tag: str) -> list:
    """The tracked run of ``kw`` stepped frame by frame on the card and on
    the CPU from the CPU run's state (map, pose, motion and anchor): the
    same branches run, map counts within 0.2% (the card's fusion may decide
    a merge at a near tie otherwise, as in the gradient phase's witness), and
    each step's pose within ``LOCKSTEP_BAR``, but on a step where a branch
    ran and the two devices
    took opposite sides of its adoption test (the recovered pose scores
    higher than the solved one: two inlier fractions at a near-tie), which
    is reported. Returns the per-frame pose gaps."""
    slam = PointFusion(**kw)
    fr = {d: slam._with_normal_pitch(rgbdimages_from_numpy(*arrays, device=d))
          for d in ("cpu", "cuda")}
    _, L_, _, _ = fr["cpu"].shape
    sched = slam._capacity_schedule(fr["cpu"])
    if len(sched) != 1 or slam.prune_every:
        raise AssertionError(f"lockstep {tag}: one capacity and no prune expected")
    live0 = fr["cpu"][:, 0]
    state = (slam._map(slam.empty_map(1, sched[0][1], device="cpu"), live0),
             live0.poses[:, 0], torch.eye(4)[None],
             slam._anchor_snapshot(live0) if slam.anchor_every else None)
    cv = slam.motion_model == "constant_velocity"

    def track(state, f, frame):  # one tracked frame, eagerly: armed or not
        if slam.relocalize_below > 0:
            return slam._track(*state, slam._refresh_frame(f), frame)
        return (*slam._track_unarmed(cv, *state[:3], frame), state[3],
                {"relocalize": None, "anchor": None})

    gaps, flips, counts = [], [], []
    for f in range(1, L_):
        card = track(tuple(to_device(x, "cuda") for x in state), f, fr["cuda"][:, f])
        cpu = track(state, f, fr["cpu"][:, f])
        gaps.append(float((card[1].cpu() - cpu[1]).abs().max()))
        ran = [{k: ev[k] is not None for k in ("relocalize", "anchor")} for ev in (card[4], cpu[4])]
        taken = [{k: None if ev[k] is None else bool(ev[k].any()) for k in ("relocalize", "anchor")}
                 for ev in (card[4], cpu[4])]
        n_card, n_cpu = int(card[0].num_points[0]), int(cpu[0].num_points[0])
        counts.append(n_card - n_cpu)
        if ran[0] != ran[1] or abs(n_card - n_cpu) > 0.002 * n_cpu:
            raise AssertionError(f"lockstep {tag} frame {f}: card {ran[0]} map {n_card}, "
                                 f"CPU {ran[1]} map {n_cpu}")
        if taken[0] != taken[1]:
            flips.append((f, taken[0], taken[1], gaps[-1]))
        elif not gaps[-1] <= LOCKSTEP_BAR:
            raise AssertionError(f"lockstep {tag} frame {f}: card vs CPU |dpose| {gaps[-1]}")
        state = cpu[:4]
    log(f"lockstep {tag}: per-step card vs CPU max |dpose| " + " ".join(
        f"{g:.2e}" for g in gaps) + f" (bar {LOCKSTEP_BAR:g}), the same branches; map count "
        f"card - CPU a step {counts} (bar 0.2%: a fusion merge decided otherwise at a near "
        f"tie); adoption decided otherwise (card, CPU, |dpose|): {flips or 'none'}")
    return gaps


def captured_beside_eager(frames, pc, poses, branches: dict, path: str, kw: dict,
                          shape: tuple) -> str:
    """An armed row's run with ``use_jit=False`` (its result ``pc``,
    ``poses``, its branch frames, its launches in ``LAUNCHES[path]``)
    beside the row captured: a first call (warm-ups and captures) and a
    second, every frame replayed as one graph whose branches are
    conditional nodes decided on the device (:func:`check_armed_graph`),
    give the eager run's SHA-256 digest of poses and map on the same branch
    frames, with the launches that the counters add up
    (``CAPTURED_LAUNCHES``, the branches' where their predicates read true)
    equal to eager's, and one host read a call, after the last frame (none
    on a branch frame, where eager reads once or twice); a profiled
    replayed call's device trace shows no more ``knn1_search`` and
    ``scatter_rows<`` events than :func:`recovery_launches` derives.
    Returns a report."""
    want = map_digest(pc, poses)
    slam = PointFusion(**kw)
    secs, ledgers, reads = {}, {}, {}
    for call in ("first", "replayed"):
        with GraphLedger(slam) as ledgers[call], ReadBacks(slam) as reads[call]:
            pc2, poses2, secs[call] = counted_run(slam, frames, f"{path}_{call}", kw, shape,
                                                  CAPTURED_LAUNCHES)
        if not slam.last_call_captured:
            raise AssertionError(f"{path}: not captured ({slam.last_eager_reason})")
        if (map_digest(pc2, poses2), branch_frames(slam)) != (want, branches):
            raise AssertionError(f"{path}: the captured {call} call differs from the eager run "
                                 f"(branches {branch_frames(slam)}, eager {branches})")
        if CAPTURED_LAUNCHES[f"{path}_{call}"] != LAUNCHES[path]:
            raise AssertionError(f"{path}: launches captured {call} "
                                 f"{CAPTURED_LAUNCHES[f'{path}_{call}']}, eager {LAUNCHES[path]}")
        if reads[call].reads != {shape[1]: 1}:
            raise AssertionError(f"{path}: the captured {call} call read back "
                                 f"{dict(reads[call].reads)} "
                                 f"(by frame), not once after its last frame")
    check_armed_graph(path, ledgers, shape[1] - 1)
    before = collections.Counter(slam.frame_graphs.branch_launches)
    trace = device_profile(lambda: slam(frames))
    expect = recovery_launches(kw, shape, slam.recovery_log)
    # the launches inside the conditional bodies that ran: what ``settle``
    # added to the counters
    inside = {k: slam.frame_graphs.branch_launches[(m.__name__, None)]
              - before[(m.__name__, None)] for k, m in (("knn", knn_cuda), ("scatter", scatter_cuda))}
    if any(trace["kernels"][k] > expect[k] for k in expect):
        raise AssertionError(f"{path}: the replayed call's device trace shows {trace['kernels']}, "
                             f"more than the {expect} derived ({inside} of them inside conditional "
                             f"bodies; {trace['stale']} events of an earlier session left out)")
    return (f"captured: first and replayed call SHA-256-equal to eager ({want[:16]}), branches "
            f"{branches}, the counters' launches {LAUNCHES[path]} in each, the replayed call's "
            f"device trace {trace['kernels']} (at most the derived; {inside} of the launches "
            f"inside conditional bodies); first {secs['first']:.4f} s, "
            f"replayed {secs['replayed']:.4f} s; graphs by key "
            f"{graphs_by_key(slam.frame_graphs)} (first call captured "
            f"{ledgers['first'].captured['armed']} in {ledgers['first'].capture_s['armed']:.4f} s, "
            f"replayed call {ledgers['replayed'].replays['armed']} replays); one read a call")


def post_kidnap_m(poses: np.ndarray, gt: np.ndarray) -> float:
    """Unaligned translation RMSE over the frames after the kidnap (8-10)."""
    err = poses[8:, :3, 3].astype(np.float64) - gt[8:, :3, 3].astype(np.float64)
    return float(np.sqrt(np.mean(np.sum(err ** 2, axis=-1))))


def kidnap_phase(golden) -> dict:
    """(1) The kidnapped clip at full width, armed with the 1-NN tracker,
    armed with the projective one, unarmed, and armed with the 1-NN
    tracker and the anchor, each held to its JAX CPU golden (the
    relocalization frames, the drift gate's re-solve frames, the
    post-kidnap error); then the relocalization on its own, the
    hypotheses as a batch of 5 and one after another. Returns the 1-NN
    kernel's inputs at the relocalization's B=5 shape."""
    rgb, depth, K, P, jump = kidnap_clip()
    frames = rgbdimages_from_numpy(rgb, depth, K, P, device="cuda")
    _, _, Hk, Wk = KIDNAP_SHAPE
    shape = (1, len(KIDNAP_ORDER), Hk, Wk)
    out = {}
    for name, row in kidnap_rows(jump).items():
        kw = dict(KIDNAP_BASE, map_capacity=shape[1] * Hk * Wk, **row)
        armed = bool(row.get("relocalize_below"))
        # an armed row eagerly, its launches counted where the wrappers
        # launch; captured beside it
        slam = PointFusion(**kw, use_jit=not armed)
        pc, poses, secs = counted_run(slam, frames, f"kidnap_{name}", kw, shape)
        check_run(pc, poses, shape, f"kidnap {name}")
        if armed:
            captured = captured_beside_eager(frames, pc, poses, branch_frames(slam),
                                             f"kidnap_{name}", kw, shape)
        post = post_kidnap_m(poses[0].cpu().numpy(), P[0])
        ref = float(golden[f"kidnap_{name}_post_ate_m"])
        readings = golden[f"kidnap_{name}_health"]
        want = ([f + 1 for f, h in enumerate(readings) if h < row.get("relocalize_below", 0)],
                [f + 1 for f, d in enumerate(golden[f"kidnap_{name}_drift"]) if d])
        got = (slam.recovery_log["relocalize"], slam.recovery_log["anchor"])
        if name == "unarmed":
            if not post > KIDNAP_UNARMED_MIN_M:
                raise AssertionError(f"kidnap unarmed: post-kidnap {post} m, not lost")
        elif not (post < KIDNAP_ATE_BAR_M and post <= KIDNAP_GOLDEN_FACTOR * ref and got == want):
            raise AssertionError(f"kidnap {name}: post-kidnap {post} m (golden {ref} m), "
                                 f"relocalized and re-solved at {got}, golden at {want}")
        health = " ".join(f"{float(h[0]):.3f}" for h in slam.recovery_log["health"])
        log(f"kidnap {name} {Hk}x{Wk}x{shape[1]}: post-kidnap unaligned RMSE {post:.4e} m "
            f"(JAX CPU golden {ref:.4e} m), relocalized at frames {got[0]}, anchor re-solves at "
            f"{got[1]} (golden {want[0]}, {want[1]}), gate readings [{health}] (golden "
            f"[{' '.join(f'{h:.3f}' for h in readings)}]), "
            f"launches {LAUNCHES[f'kidnap_{name}']} as derived, {secs:.3f} s "
            f"({'captured' if slam.last_call_captured else 'eager'}), map "
            f"{int(pc.num_points[0])} (golden {int(golden[f'kidnap_{name}_num_points'])})"
            + (f"; {captured}" if armed else ""))
        out[name] = (pc, poses)

    # the relocalization alone, from the default grid around frame 7's
    # pose, for the kidnapped frame 8 against the armed run's map
    pc, poses = out["knn"]
    anchors = perturbation_grid(poses[:, 7])
    res = {}
    for mode in ("vmap", "scan"):
        knn_cuda.launches = scatter_cuda.launches = 0
        with KnnCapture() as cap:
            res[mode] = relocalize(pc, frames[:, 8], anchors, dsratio=8, numiters=12,
                                   robust_scale=KIDNAP_BASE["robust_scale"], hypothesis_mode=mode)
        torch.cuda.synchronize()
        K_ = anchors.shape[1]
        n = 1 if mode == "vmap" else K_
        expect = {"knn": n * (2 * 12 + 1), "scatter": n * 10}
        LAUNCHES[f"relocalize_{mode}_K{K_}"] = {"knn": knn_cuda.launches,
                                                "scatter": scatter_cuda.launches}
        if LAUNCHES[f"relocalize_{mode}_K{K_}"] != expect:
            raise AssertionError(f"relocalize {mode}: launches "
                                 f"{LAUNCHES[f'relocalize_{mode}_K{K_}']}, expected {expect}")
        if mode == "vmap":
            b5 = cap.args
    (pv, iv), (ps, is_) = res["vmap"], res["scan"]
    gap = float((pv - ps).abs().max())
    if not (torch.equal(iv["best_hypothesis"], is_["best_hypothesis"]) and gap <= 1e-4):
        winners = (iv["best_hypothesis"].tolist(), is_["best_hypothesis"].tolist())
        raise AssertionError(f"relocalize: vmap and scan disagree (winners {winners}, "
                             f"|dpose| {gap})")
    log(f"relocalize K={anchors.shape[1]} at ds 8: vmap and scan pick hypothesis "
        f"{int(iv['best_hypothesis'][0])}, |dpose| {gap:.3e}, scores "
        f"{iv['hypothesis_inlier_frac'][0].tolist()}; the batched 1-NN input "
        f"{tuple(b5[0].shape)} against {tuple(b5[1].shape)}")
    return b5


def anchor_knn_inputs(frames) -> tuple:
    """The anchor re-solve's 1-NN inputs on the easy clip: frame 1's ds-4
    cloud against frame 0's anchor snapshot (both at their poses)."""
    slam = PointFusion(**ARMED_BASE, **ARMED_ROWS["relocalize_anchor"])
    pts, _, cnt = slam._anchor_snapshot(frames[:, 0])
    src = downsample_rgbdimages(frames[:, 1], slam.dsratio)
    mask = torch.arange(pts.shape[1], device=pts.device)[None] < cnt[:, None]
    return src.points.contiguous(), pts.contiguous(), mask


def device_profile(run) -> dict:
    """One call of ``run`` under ``torch.profiler`` with the device's
    activity only (no host op records, so the trace is read in seconds):
    the device's busy seconds (``busy_s``) and its number of events; the
    launches of the port's kernels that the trace shows (``kernels``, as
    :class:`PhaseTrace` counts them); the device-to-device copies
    (``copies``, ``copy_s``: a graph's static inputs written before its
    replay, and the copies inside the graphs and eager code). The session
    starts with a marker kernel (``torch.cuda._sleep``) and a synchronize;
    events that started before the marker ended belong to an earlier
    session and are left out with the marker (``stale``). Kernels inside
    a CUDA graph conditional body are named rightly only where CUPTI is
    torn down after each session (``TEARDOWN_CUPTI=1``, set above): left
    up, it reported them on a stream of their own, the 1-NN's three
    kernels named in reverse order at about 1.3 us each and in other
    numbers than the body launched."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(100_000)
        torch.cuda.synchronize()
        run()
        torch.cuda.synchronize()
    # the raw trace: the profiler's own parse into a tree of events takes
    # seconds a run at 100,000 events
    events = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CUDA]
    ours = [e for e in events if PhaseTrace.MARKER not in e.name()]
    marks = [e.start_ns() + e.duration_ns() for e in events
             if PhaseTrace.MARKER in e.name() and e.duration_ns() >= PhaseTrace.MARK_NS]
    start = max(marks) if marks else -1
    device = [e for e in ours if e.start_ns() > start]
    stale = len(ours) - len(device)
    busy = union_s([(e.start_ns(), e.start_ns() + e.duration_ns()) for e in device], 1e-9)
    check_profile("device_events", busy, len(device))
    copies = [e.duration_ns() for e in device if "Memcpy DtoD" in e.name()]
    return dict(busy_s=busy, events=len(device), copies=len(copies), copy_s=sum(copies) * 1e-9,
                kernels={k: sum(kernel in e.name() for e in device)
                         for k, kernel in COUNTED_KERNELS.items()}, stale=stale)


def device_events(run) -> tuple:
    """:func:`device_profile`'s device busy seconds and events."""
    p = device_profile(run)
    return p["busy_s"], p["events"]


class ReadBackEachFrame:
    """The unarmed pipeline with one value read back to the host after each
    frame's localization: the armed gate's synchronization without its
    work, to split the armed rows' cost."""

    def __init__(self, slam):
        self.slam, self._real = slam, slam._localize

    def __enter__(self):
        def localize(*args, **kwargs):
            out = self._real(*args, **kwargs)
            bool(torch.isfinite(out[..., 0, 0]).all())
            return out

        self.slam._localize = localize
        return self

    def __exit__(self, *exc):
        del self.slam._localize


def device_syncs(run) -> int:
    """The synchronizing CUDA operations of one call of ``run``, as
    ``torch.cuda.set_sync_debug_mode("warn")`` reports them: every read
    back to the host, wherever the code makes it."""
    torch.cuda.synchronize()
    mode = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode(mode)
    return sum("synchroniz" in str(w.message) for w in seen)


# rounds of one run of each armed row, the order reversed every other round
# (4 until PR 19; 2 for the script's time limit, PERF.md §4)
ARMED_ROUNDS = 1
# the armed healthy rows on the clip's first 15 frames (the first three
# capacity segments; the anchored row refreshes on frame 10): the script's
# time limit (PERF.md §4)
ARMED_L = 15
ARMED_SCHEDULE = SCHEDULE[:3]


def armed_phase(frames) -> dict:
    """(2) The armed healthy rows on the easy clip against the unarmed one,
    each eager (``use_jit=False``) and captured (``use_jit=True``: the
    armed rows as one graph a frame, its branches conditional nodes
    decided on the device, and one read back a run):
    the same bits in every run, no branch run, launches equal between the
    modes (the captured runs' counts, added up on replay, in
    ``CAPTURED_LAUNCHES``, and their device trace showing no more kernels
    than derived), and their cost; beside them the eager unarmed row with
    one read back a frame and nothing else. The rows run in rounds, one run
    of each a round, so that each ratio pairs runs made next to each other.
    Then one profiled run of each row (:func:`device_profile`) counts its
    synchronizing operations under the sync debug mode "warn"
    (:func:`device_syncs`): eagerly one a tracked frame more than the
    unarmed row, captured at most one a run more than the captured unarmed
    row (the predicates' one read). Last, the device time of one copy of
    the final map, the cost a split armed frame (gate and fuse graphs, as
    under grad) pays once more than an unarmed one: the fuse graph's
    static inputs written from the gate's."""
    frames = frames[:, :ARMED_L]
    shape = (B, ARMED_L, H, W)
    names = (*ARMED_ROWS, "unarmed_read_back", *(f"{n}_captured" for n in ARMED_ROWS))

    def row_kw(name):
        return dict(ARMED_BASE, map_capacity=ARMED_SCHEDULE,
                    **ARMED_ROWS.get(name.removesuffix("_captured"), {}))

    slams = {name: PointFusion(**row_kw(name), use_jit=name.endswith("_captured"))
             for name in names}

    def run(name, counted):
        slam = slams[name]
        with (ReadBackEachFrame(slam) if name == "unarmed_read_back"
              else contextlib.nullcontext()):
            if not counted:
                return slam(frames)
            store = CAPTURED_LAUNCHES if name.endswith("_captured") else LAUNCHES
            return counted_run(slam, frames, f"armed_{name}", row_kw(name), shape, store)

    wall = dict.fromkeys(names, 0.0)  # each row's share of the phase's time
    for name in names:
        t0 = time.perf_counter()
        run(name, counted=False)  # warm-up (captured: the warm-ups and captures)
        wall[name] += time.perf_counter() - t0
    secs = {name: [] for name in names}
    peaks = dict.fromkeys(names, 0)
    digests = {}
    for r in range(ARMED_ROUNDS):
        for name in (names if r % 2 == 0 else names[::-1]):
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            pc, poses, t = run(name, counted=True)
            secs[name].append(t)
            peaks[name] = max(peaks[name], torch.cuda.max_memory_allocated())
            slam = slams[name]
            if any(branch_frames(slam).values()):
                raise AssertionError(f"armed {name}: a branch ran: {branch_frames(slam)}")
            if slam.last_call_captured != name.endswith("_captured"):
                raise AssertionError(f"armed {name}: last_call_captured "
                                     f"{slam.last_call_captured} ({slam.last_eager_reason})")
            check_run(pc, poses, shape, f"armed {name}")
            digests[f"{name} round {r}"] = map_digest(pc, poses)
            wall[name] += time.perf_counter() - t0
    if len(set(digests.values())) != 1:
        raise AssertionError(f"armed rows: poses and map differ from the unarmed run: {digests}")
    for name in ARMED_ROWS:
        if LAUNCHES[f"armed_{name}"] != CAPTURED_LAUNCHES[f"armed_{name}_captured"]:
            raise AssertionError(f"armed {name}: launches eager {LAUNCHES[f'armed_{name}']}, "
                                 f"captured {CAPTURED_LAUNCHES[f'armed_{name}_captured']}")
    rows = {}
    for name in names:
        captured = name.endswith("_captured")
        syncs = []
        t0 = time.perf_counter()
        expect = recovery_launches(row_kw(name), shape, slams[name].recovery_log)
        with (ReadBackEachFrame(slams[name]) if name == "unarmed_read_back"
              else contextlib.nullcontext()):
            prof = device_profile(lambda: syncs.append(device_syncs(lambda: slams[name](frames))))
        wall[name] += time.perf_counter() - t0
        if captured and any(prof["kernels"][k] > expect[k] for k in expect):
            raise AssertionError(f"armed {name}: the device trace shows {prof['kernels']}, more "
                                 f"than the {expect} derived")
        mean = float(np.mean(secs[name]))
        rows[name] = dict(s=mean, peak_b=peaks[name], syncs=syncs[0], **prof)
        launches = (CAPTURED_LAUNCHES if captured else LAUNCHES)[f"armed_{name}"]
        log(f"armed {name} {H}x{W}x{ARMED_L}: {ARMED_L / mean:.4f} frames/s ({mean:.4f} s/run, mean of "
            f"{ARMED_ROUNDS}: " + " ".join(f"{t:.4f}" for t in secs[name]) + f"), peak memory "
            f"{peaks[name]} B, device busy {prof['busy_s']:.4f} s "
            f"({100 * prof['busy_s'] / mean:.1f}% of the mean run), {prof['events']} device "
            f"events, {prof['copies']} "
            f"device-to-device copies ({prof['copy_s']:.4f} s), {syncs[0]} synchronizing "
            f"operations in a run, launches {launches}"
            + (f" (the device trace shows {prof['kernels']})" if captured else "")
            + f"; {wall[name]:.2f} s for the row's runs and checks")
    for mode in ("", "_captured"):
        base = rows[f"unarmed{mode}"]["syncs"]
        read_back = () if mode else ("unarmed_read_back",)
        for name in ("relocalize", "relocalize_anchor", *read_back):
            more = rows[name + mode]["syncs"] - base
            if (more > 1) if mode else (more != ARMED_L - 1):
                raise AssertionError(f"armed {name + mode}: {rows[name + mode]['syncs']} "
                                     f"synchronizing operations a run, the unarmed row {base}: "
                                     + ("more than one more a run" if mode
                                        else "not one more a tracked frame"))
    m = graphs_module.flatten(pc)[0]
    copy = [torch.empty_like(t) for t in m]
    map_ms = device_ms(lambda: [d.copy_(t) for d, t in zip(copy, m)], 20)
    del copy

    def paired(name, base):
        ratios = [a / b for a, b in zip(secs[name], secs[base])]
        return f"{float(np.median(ratios)):.3f}x time (rounds " + " ".join(
            f"{x:.3f}" for x in ratios) + ")"

    def against(base, names_):
        b = rows[base]
        return "; ".join(
            f"{name} {paired(name, base)}, {rows[name]['peak_b'] - b['peak_b']:+d} B peak, "
            f"{rows[name]['events'] - b['events']:+d} device events, "
            f"{rows[name]['busy_s'] - b['busy_s']:+.4f} s busy, "
            f"{rows[name]['copy_s'] - b['copy_s']:+.4f} s in device-to-device copies "
            f"({rows[name]['copies'] - b['copies']:+d})" for name in names_)

    log("armed rows: poses and map SHA-256-equal to the unarmed run's in every round and "
        "mode, launches equal between the modes; eager, against the eager unarmed row, "
        "paired by round: " + against("unarmed", ("relocalize", "relocalize_anchor",
                                                  "unarmed_read_back"))
        + "; captured, against the captured unarmed row (the port's reading of the 0.95x "
        "frames/s bar, reported): " + against("unarmed_captured", (
            "relocalize_captured", "relocalize_anchor_captured"))
        + " (frames/s against the captured unarmed row: " + ", ".join(
            f"{name} {float(np.mean(secs['unarmed_captured'])) / float(np.mean(secs[name])):.4f}x"
            for name in ("relocalize_captured", "relocalize_anchor_captured"))
        + ", JAX's bar 0.95x, not barred)"
        + "; captured against eager: " + "; ".join(
            f"{name} {paired(name + '_captured', name)}" for name in ARMED_ROWS)
        + f"; one copy of the final map ({int(pc.num_points[0])} points, "
        f"{sum(t.numel() * t.element_size() for t in m)} B): {map_ms:.4f} ms of device time")
    return rows


def drift_phase(golden) -> None:
    """(3) The drift clip: card against the CPU run of the same code frame by
    frame; the plain run drifts, the anchored one re-solves, and their
    errors are reported beside the golden's (see ``DRIFT_MIN_FINAL_M``)."""
    arrays = hard_sequence(*DRIFT_SHAPE, outlier_frac=0.0)
    frames = rgbdimages_from_numpy(*arrays, device="cuda")
    _, Ld, Hd, Wd = DRIFT_SHAPE
    ates, finals, fired = {}, {}, {}
    for name, row in DRIFT_ROWS.items():
        kw = dict(DRIFT_BASE, map_capacity=Ld * Hd * Wd, **row)
        lockstep(kw, arrays, f"drift {name} {Hd}x{Wd}x{Ld}")
        armed = bool(row.get("relocalize_below"))
        slam = PointFusion(**kw, use_jit=not armed)  # armed: eagerly, captured beside
        pc, poses, secs = counted_run(slam, frames, f"drift_{name}", kw, DRIFT_SHAPE)
        check_run(pc, poses, DRIFT_SHAPE, f"drift {name}")
        captured = ""
        if armed:
            captured = "; " + captured_beside_eager(frames, pc, poses, branch_frames(slam),
                                                    f"drift_{name}", kw, DRIFT_SHAPE)
        est = poses[0].cpu()
        ates[name] = float(ate_rmse(est, torch.from_numpy(arrays[3][0])))
        finals[name] = float(np.linalg.norm(est.numpy()[-1, :3, 3] - arrays[3][0, -1, :3, 3]))
        fired[name] = slam.recovery_log["anchor"]
        log(f"drift {name}: aligned ATE {ates[name]:.4e} m (JAX CPU golden "
            f"{float(golden[f'drift_{name}_ate_m']):.4e} m), final error {finals[name]:.4e} m, "
            f"anchor re-solves at frames {fired[name]}, launches {LAUNCHES[f'drift_{name}']}, "
            f"{secs:.3f} s{captured}")
    if not (finals["plain"] > DRIFT_MIN_FINAL_M and fired["anchored"]):
        raise AssertionError(f"drift: plain final error {finals['plain']} m, anchor re-solves "
                             f"{fired['anchored']}")
    ratio = float(golden["drift_anchored_ate_m"]) / float(golden["drift_plain_ate_m"])
    log(f"drift: anchored / plain ATE {ates['anchored'] / ates['plain']:.3f} on the card "
        f"(JAX CPU golden {ratio:.3f}; no bar, see DRIFT_MIN_FINAL_M)")


def subpixel_phase(frames, golden) -> None:
    """(4) Sub-pixel association and point rows: the easy clip against the
    golden, the hard-clip row card against CPU at 160x120, and at full
    width beside the golden."""
    shape = (B, L, H, W)
    gt = frames.poses[0].cpu()
    for name, kw in SUBPIXEL_ROWS.items():
        slam = PointFusion(**kw)
        pc, poses, secs, peak = warm_and_time(slam, frames, f"subpixel_{name}", kw, shape)
        count = check_run(pc, poses, shape, f"subpixel {name}")
        ate = float(ate_rmse(poses[0].cpu(), gt))
        ref_ate = float(golden[f"subpixel_{name}_ate_m"])
        ref_n = int(golden[f"subpixel_{name}_num_points"])
        if not (ate <= SUBPIXEL_ATE_FACTOR * ref_ate and abs(count - ref_n) <= 0.002 * ref_n):
            raise AssertionError(f"subpixel {name}: aligned ATE {ate} m (golden {ref_ate} m), "
                                 f"map {count} (golden {ref_n})")
        log(f"subpixel {name} {H}x{W}x{L}: {L / secs:.4f} frames/s, aligned ATE {ate:.4e} m "
            f"(JAX CPU golden {ref_ate:.4e} m), map {count} (golden {ref_n}, "
            f"{100 * (count - ref_n) / ref_n:+.3f}%), peak {peak} B, launches "
            f"{LAUNCHES[f'subpixel_{name}']}")
    lockstep(SMALL_SUBPIXEL, hard_sequence(1, SMALL_L, SMALL_H, SMALL_W),
             f"hard subpixel {SMALL_H}x{SMALL_W}x{SMALL_L}")
    arrays = hard_sequence(B, L, H, W)
    hard = rgbdimages_from_numpy(*arrays, device="cuda")
    slam = PointFusion(**HARD_SUBPIXEL)
    pc, poses, secs = counted_run(slam, hard, "hard_subpixel", HARD_SUBPIXEL, shape)
    count = check_run(pc, poses, shape, "hard subpixel")
    ate = float(ate_rmse(poses[0].cpu(), torch.from_numpy(arrays[3][0])))
    log(f"hard subpixel {H}x{W}x{L} (no bar: the clip is chaotic): aligned ATE {ate:.4e} m "
        f"(JAX CPU golden {float(golden['hard_subpixel_ate_m']):.4e} m), map {count} (golden "
        f"{int(golden['hard_subpixel_num_points'])}), {secs:.3f} s, launches "
        f"{LAUNCHES['hard_subpixel']}")


def large_map_phase() -> list:
    """(5) The large map, three pipelines against the golden. Returns the
    scatter kernel's calls of the gt run's last frame (window compaction,
    winner table, row inversion into the 1.16M-row map)."""
    golden = np.load(LARGE_GOLDEN)
    arrays = synthetic_sequence(*LARGE_SHAPE, speed=LARGE_SPEED)
    frames = rgbdimages_from_numpy(*arrays, device="cuda")
    gt = torch.from_numpy(arrays[3][0])
    calls = None
    for name, row in LARGE_ROWS.items():
        kw = dict(row, map_capacity=LARGE_SCHEDULE)
        slam = PointFusion(**kw)
        with ScatterCapture() as cap:
            pc, poses, secs, peak = warm_and_time(slam, frames, f"large_{name}", kw, LARGE_SHAPE)
        if name == "gt":  # the last frame's window, winner table and row inversion
            _, _, Hl, Wl = LARGE_SHAPE
            last = LARGE_SCHEDULE[-1][1]
            calls = [cap.calls[size] for size in sorted({min(2 * Hl * Wl, last), Hl * Wl, last})
                     if size in cap.calls]
        count = check_run(pc, poses, LARGE_SHAPE, f"large {name}")
        ref = int(golden[f"{name}_num_points"])
        if abs(count - ref) > LARGE_COUNT_REL * ref:
            raise AssertionError(f"large {name}: map {count}, golden {ref}")
        quality = ""
        if row["odom"] != "gt":
            ate, ref_ate = float(ate_rmse(poses[0].cpu(), gt)), float(golden[f"{name}_ate_m"])
            if not ate <= LARGE_ATE_FACTOR * ref_ate:
                raise AssertionError(f"large {name}: aligned ATE {ate} m, golden {ref_ate} m")
            quality = f", aligned ATE {ate:.4e} m (JAX CPU golden {ref_ate:.4e} m)"
        log(f"large map {name} {LARGE_SHAPE[2]}x{LARGE_SHAPE[3]}x{LARGE_SHAPE[1]}: "
            f"{LARGE_SHAPE[1] / secs:.4f} frames/s ({secs:.4f} s/run), map {count} points "
            f"(golden {ref}, {100 * (count - ref) / ref:+.4f}%), 0 dropped{quality}, peak "
            f"{peak} B, launches {LAUNCHES[f'large_{name}']}")
    return calls


def recovery_phase(frames) -> tuple:
    """Phases (1)-(5) of the recovery slice. Returns the 1-NN kernel's new
    timed shapes and the scatter kernel's."""
    golden = np.load(RECOVERY_GOLDEN)
    t0 = time.perf_counter()
    b5 = kidnap_phase(golden)
    log(f"kidnap phase: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    armed_phase(frames)
    log(f"armed phase: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    drift_phase(golden)
    subpixel_phase(frames, golden)
    log(f"drift and subpixel phases: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    calls = large_map_phase()
    log(f"large map phase: {time.perf_counter() - t0:.2f} s")

    # both kernels at the slice's new shapes, against their plain versions
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock_hz = max_sm_clock_hz()
    knn_rows, max_err = [], 0.0
    for name, args in (("relocalize_B5", b5), ("anchor_resolve", anchor_knn_inputs(frames))):
        max_err = max(max_err, check_knn_case(name, *args))
        row = time_knn(*args, sms, clock_hz)
        row["case"] = name
        knn_rows.append(row)
    scatter_rows_ = []
    for size, dest, values, fill in calls:
        name = f"large_map_table_{size}"
        k = scatter_kernel(size, dest.contiguous(), values.contiguous(), fill)
        if not torch.equal(int_view(k), int_view(scatter_plain(size, dest, values, fill))):
            raise AssertionError(f"scatter {name}: kernel differs from the plain version")
        log(f"scatter {name}: dest {tuple(dest.shape)} {dest.dtype}, values "
            f"{tuple(values.shape)} {values.dtype}, bit-equal to the plain version")
        scatter_rows_.append(time_scatter(name, size, dest.contiguous(), values.contiguous(),
                                          fill))
    return knn_rows, max_err, scatter_rows_

class ScatterIntoCapture:
    """Keeps the last scatter call into a buffer of each row width made
    while it is active (the kernel still runs)."""

    def __init__(self):
        self.calls = {}

    def __enter__(self):
        self._real = pointclouds_module._scatter_rows_into

        def spy(buf, dest, values):
            self.calls[buf.shape[-1]] = (buf, dest, values, 0)
            return self._real(buf, dest, values)

        pointclouds_module._scatter_rows_into = spy
        return self

    def __exit__(self, *exc):
        pointclouds_module._scatter_rows_into = self._real


@functools.lru_cache(maxsize=None)
def semantic_frames(shape: tuple) -> tuple:
    """A clip of ``shape`` on the card without and with its stripe plane,
    and its poses on the host; made once for each shape."""
    rgb, depth, K, P = grad_arrays(shape)
    plain = rgbdimages_from_numpy(rgb, depth, K, P, device="cuda")
    plane = torch.from_numpy(stripe_plane(depth, K, P)).cuda()
    return plain, dataclasses.replace(plain, feature_image=plane), P


def semantic_launches(cls: str, kw: dict, shape: tuple, log: dict) -> dict:
    """Both kernels' launches of one semantic row: ICPSLAM's aggregate map
    appends points, normals and colors, and features with user channels, a
    scatter each a frame; PointFusion as :func:`recovery_launches`."""
    if cls == "ICPSLAM":
        return {"knn": 0, "scatter": (4 if kw.get("feature_channels") else 3) * shape[1]}
    return recovery_launches(kw, shape, log)


def geometry_digest(pc, poses, base: int) -> str:
    """Poses, counts, points, normals, colors and the first ``base`` feature
    channels (the bookkeeping the featureless map carries)."""
    parts = [poses, pc.num_points, pc.num_dropped, pc.points, pc.normals]
    parts += [b for b in (pc.colors,) if b is not None]
    if base:
        parts.append(pc.features[..., :base])
    return sha256_of(*parts)


def semantic_row(name: str, golden) -> dict:
    """One row of SEMANTIC_ROWS with feature_channels 0 and SEM_F: a warm-up
    each, then two counted runs each in turns (frames/s from the median);
    the F = SEM_F map against the golden and the F = 0 run. Returns the
    F = SEM_F run's scatter calls (new tables by size, writes into a buffer
    by row width)."""
    cls, shape, kw = SEMANTIC_ROWS[name]
    plain, sem, P = semantic_frames(shape)
    frames = {0: plain, SEM_F: sem}
    # eager: the spies below read each call's inputs, which a replay skips
    slams = {nf: globals()[cls](**kw, feature_channels=nf, use_jit=False) for nf in frames}
    for nf, slam in slams.items():
        slam(frames[nf])
    runs, secs, peaks = {}, {0: [], SEM_F: []}, {0: 0, SEM_F: 0}
    for nf in (0, SEM_F, SEM_F, 0):  # two timed runs each, in turns
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        knn_cuda.launches = 0
        scatter_cuda.launches = 0
        with ScatterCapture() as cap, ScatterIntoCapture() as cap_into:
            t0 = time.perf_counter()
            pc, poses = slams[nf](frames[nf])
            torch.cuda.synchronize()
            secs[nf].append(time.perf_counter() - t0)
        path = f"semantic_{name}_F{nf}"
        LAUNCHES[path] = {"knn": knn_cuda.launches, "scatter": scatter_cuda.launches}
        expect = semantic_launches(cls, dict(kw, feature_channels=nf), shape,
                                   slams[nf].recovery_log)
        if LAUNCHES[path] != expect:
            raise AssertionError(f"{path}: launches {LAUNCHES[path]}, expected {expect}")
        check_run(pc, poses, shape, path)
        peaks[nf] = max(peaks[nf], torch.cuda.max_memory_allocated())
        runs[nf] = (pc, poses, cap, cap_into)
    (pc0, poses0, _, _), (pc, poses, cap, cap_into) = runs[0], runs[SEM_F]
    secs0, secs = float(np.median(secs[0])), float(np.median(secs[SEM_F]))
    peak0, peak = peaks[0], peaks[SEM_F]
    base0 = 0 if pc0.features is None else pc0.features.shape[-1]
    base = pc.features.shape[-1] - SEM_F
    failed = []
    same_geometry = geometry_digest(pc, poses, base0) == geometry_digest(pc0, poses0, base0)
    if not same_geometry:
        failed.append(f"the F={SEM_F} map's geometry or poses differ from the F=0 run's")
    n = int(pc.num_points[0])
    ref = int(golden[f"{name}_num_points"])
    if abs(n - ref) > SEM_COUNT_REL * ref:
        failed.append(f"map {n}, golden {ref}")
    user = pc.features[0, :n, base:].double()
    one = float((user.sum(-1) - 1.0).abs().max())
    if not one <= SEM_ONE_ATOL:
        failed.append(f"a point's features sum to 1 +- {one}")
    x = pc.points[0, :n, 0].double()
    quality = ""
    if kw["odom"] != "gt":
        gt = torch.from_numpy(P[0])
        ate, ref_ate = float(ate_rmse(poses[0].cpu(), gt)), float(golden[f"{name}_ate_m"])
        if not ate <= SEM_ATE_FACTOR * ref_ate:
            failed.append(f"aligned ATE {ate} m, golden {ref_ate} m")
        # rpe on the card against JAX's on the same poses (the golden's)
        same = rpe(torch.from_numpy(golden[f"{name}_poses"]).cuda(), gt.cuda())
        same, ref_rpe = np.array([float(v) for v in same]), golden[f"{name}_rpe"]
        gap = np.abs(same - ref_rpe)
        if not (gap[0] <= SEM_RPE_REL * ref_rpe[0]
                and gap[1] <= max(SEM_RPE_REL * ref_rpe[1], SEM_RPE_ROT_ATOL)):
            failed.append(f"rpe {same} on the golden's poses, JAX {ref_rpe}")
        own = [float(v) for v in rpe(poses[0], gt.cuda())]
        quality = (f", aligned ATE {ate:.4e} m (golden {ref_ate:.4e} m), rpe {own[0]:.4e} m "
                   f"{own[1]:.4e} rad (golden {ref_rpe[0]:.4e} m {ref_rpe[1]:.4e} rad; the card's "
                   f"rpe on the golden's poses {gap[0]:.2e} m and {gap[1]:.2e} rad from JAX's)")
    sums, ref_sums = user.sum(0).cpu().numpy(), golden[f"{name}_feature_sums"]
    rel = np.abs(sums - ref_sums) / np.maximum(np.abs(ref_sums), 1.0)
    bar = SEM_SUM_REL["gt" if kw["odom"] == "gt" else "tracked"]
    if not rel.max() <= bar:
        failed.append(f"channel sums {sums.tolist()}, golden {ref_sums.tolist()}")
    label = user.argmax(-1)
    stripe = torch.remainder(torch.floor((x + 10.0) / SEM_STRIPE_M).long(), SEM_F)
    agree = float((label == stripe).double().mean())
    if not agree >= SEM_CLASS_MIN:
        failed.append(f"argmax class is the point's stripe on {agree}")
    hist = torch.bincount(label, minlength=SEM_F).cpu().numpy()
    L_ = shape[1]
    log(f"semantic {name} {shape[3]}x{shape[2]}x{L_}: F={SEM_F} map {n} (golden {ref}, "
        f"{100 * (n - ref) / ref:+.4f}%), channel sums within {rel.max():.2e} of the golden's "
        f"(bar {bar:g}), one-hot sums within {one:.2e} of 1, argmax = stripe on "
        f"{100 * agree:.3f}% of points, class histogram {hist.tolist()} (golden "
        f"{golden[f'{name}_class_hist'].tolist()}); geometry and poses SHA-256-"
        f"{'equal to' if same_geometry else 'different from'} F=0{quality}; "
        f"{L_ / secs:.4f} frames/s F={SEM_F} vs {L_ / secs0:.4f} F=0; peak {peak} B vs {peak0} B; "
        f"launches {LAUNCHES[f'semantic_{name}_F{SEM_F}']} vs {LAUNCHES[f'semantic_{name}_F0']}")
    if failed:
        raise AssertionError(f"semantic {name}: " + "; ".join(failed))
    return {"new": cap.calls, "into": cap_into.calls}


def step_loop(slam, frames, cv: bool, split: bool = False):
    """The online loop of ``examples/online_slam.py`` on a fresh
    ``ONLINE_CAP`` map: frame 0 bootstraps at its own pose, each later
    frame is tracked from the previous returned pose (``odom='gt'``: fused
    at its own), with ``cv`` the previous step's motion threaded as
    ``prev_transform`` (the identity first); with ``split`` a step is
    ``localize`` then ``map_update``."""
    B_, L_ = frames.shape[:2]
    pc, pose = slam.step(slam.empty_map(B_, ONLINE_CAP, device=frames.device), frames[:, 0])
    poses = [pose[:, 0]]
    delta = torch.eye(4, device=pose.device).expand(B_, 4, 4) if cv else None
    for f in range(1, L_):
        live = frames[:, f]
        prev = None if slam.odom == "gt" else frames[:, f - 1].with_poses(poses[-1][:, None])
        if split:
            pose = slam.localize(pc, live, prev, prev_transform=delta)
            pc = slam.map_update(pc, live.with_poses(pose))
        else:
            pc, pose = slam.step(pc, live, prev, prev_transform=delta)
        if cv:
            delta = compose_transformations(pose[:, 0], inverse_transformation(poses[-1]))
        poses.append(pose[:, 0])
    return pc, torch.stack(poses, dim=1)


def online_rows() -> None:
    """(2) Each ONLINE_ROWS pipeline at ``ONLINE_CAP``: ``forward``, the step
    loop and (tracked) the localize -> map_update loop, a warm-up each, then
    two counted runs each in turns: digests and both kernels' launches
    equal, frames/s from the median."""
    plain, sem, _ = semantic_frames((B, L, H, W))
    for name, kw in ONLINE_ROWS.items():
        frames = sem if kw.get("feature_channels") else plain
        slam = PointFusion(map_capacity=ONLINE_CAP, **kw)
        cv = kw.get("motion_model") == "constant_velocity"
        loops = {"forward": lambda: slam(frames), "step": lambda: step_loop(slam, frames, cv)}
        if kw["odom"] != "gt":
            loops["localize_map_update"] = lambda: step_loop(slam, frames, cv, split=True)
        for run in loops.values():
            run()
        seen, secs, digests, counts = {}, {loop: [] for loop in loops}, set(), set()
        for loop in list(loops) + list(loops)[::-1]:  # two counted runs each, in turns
            torch.cuda.synchronize()
            knn_cuda.launches = 0
            scatter_cuda.launches = 0
            t0 = time.perf_counter()
            pc, poses = loops[loop]()
            torch.cuda.synchronize()
            secs[loop].append(time.perf_counter() - t0)
            path = f"online_{name}_{loop}"
            LAUNCHES[path] = {"knn": knn_cuda.launches, "scatter": scatter_cuda.launches}
            seen[loop] = (map_digest(pc, poses), LAUNCHES[path], float(np.median(secs[loop])),
                          int(pc.num_points[0]))
            digests.add(seen[loop][0])
            counts.add(json.dumps(LAUNCHES[path], sort_keys=True))
        if len(digests) != 1 or len(counts) != 1:
            raise AssertionError(f"online {name}: {seen}")
        log(f"online {name} {W}x{H}x{L} at capacity {ONLINE_CAP}: digests equal "
            f"({seen['forward'][0][:16]}), map {seen['forward'][3]}, launches "
            f"{seen['forward'][1]} in every loop; frames/s "
            + ", ".join(f"{loop} {L / v[2]:.4f}" for loop, v in seen.items()))


def knn_rows_check(golden) -> tuple:
    """(3) K-NN and estimate_normals at K = KNN_K: frame 0's stride-4 cloud
    against the golden, knn_points(K=1) against nn_points_auto, the full
    cloud's K sets on sampled rows against a brute-force row, its normals
    against the frame's. Returns the 1-NN kernel's case at the stride-4
    cloud (timed by the caller)."""
    from gradslam_torch.ops import knn as knn_module

    rgb, depth, K, P = grad_arrays((B, L, H, W))
    host = stride_cloud(depth, K, P)
    if hashlib.sha256(host.tobytes()).hexdigest() != str(golden["knn_input_sha256"]):
        raise AssertionError("knn: the stride-4 cloud differs from the golden's input")
    pts = torch.from_numpy(host).cuda()
    N = pts.shape[1]

    def brute(src_rows, tgt):
        s2 = knn_module._sq_norm_fma(src_rows)[:, :, None]
        t2 = knn_module._sq_norm_fma(tgt)[:, None, :]
        return s2 + t2 - 2.0 * torch.bmm(src_rows, tgt.transpose(1, 2))

    def near_tie_rows(idx, ref_idx, rows, tgt):
        """Rows whose K sets differ; each must differ only among targets
        within 1e-6 of the row's K-th distance (a tie up to rounding)."""
        differ = (idx != ref_idx).any(-1).nonzero()[:, 0]
        for r in differ.tolist():
            d = brute(tgt[:, rows[r]:rows[r] + 1], tgt)[0, 0]
            kth = torch.sort(d).values[KNN_K - 1]
            for i in set(idx[r].tolist()) ^ set(ref_idx[r].tolist()):
                if abs(float(d[i] - kth)) > 1e-6 * max(1.0, float(kth)):
                    raise AssertionError(f"knn: row {rows[r]} neighbour {i} at {float(d[i])}, "
                                         f"K-th {float(kth)}")
        return len(differ)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = knn_points(pts, pts, K=KNN_K)
    torch.cuda.synchronize()
    small_s = time.perf_counter() - t0
    ref_idx = torch.from_numpy(golden["knn_idx_delta"].astype(np.int64)
                               + np.arange(N)[:, None]).cuda()
    ties = near_tie_rows(res.idx[0].long(), ref_idx, list(range(N)), pts)
    normals = estimate_normals(Pointclouds(points=pts, num_points=torch.tensor([N]).cuda()),
                               k=KNN_K - 1).normals[0, ::KNN_GOLDEN_NORMAL_ROWS]
    n_gap = float((normals.cpu() - torch.from_numpy(golden["knn_normals"])).abs().max())
    if not n_gap <= KNN_NORMAL_ATOL:
        raise AssertionError(f"knn: normals {n_gap} from the golden's")
    log(f"knn_points K={KNN_K} on frame 0's stride-{KNN_STRIDE} cloud ({N} points): neighbour "
        f"indices equal to the JAX golden's on {N - ties} of {N} rows ({ties} differ only at "
        f"ties within 1e-6), {small_s:.4f} s; estimate_normals(k={KNN_K - 1}) within {n_gap:.2e} "
        "of the golden's")

    knn_cuda.launches = 0
    one = knn_points(pts, pts, K=1)
    LAUNCHES["knn_points_k1"] = {"knn": knn_cuda.launches, "scatter": 0}
    d1, i1 = nn_points_auto(pts, pts)
    if LAUNCHES["knn_points_k1"]["knn"] != 1 or not (
            torch.equal(one.dists[..., 0], d1) and torch.equal(one.idx[..., 0], i1)):
        raise AssertionError(f"knn_points(K=1): launches {LAUNCHES['knn_points_k1']}, or differs "
                             "from nn_points_auto")

    frames = rgbdimages_from_numpy(rgb[:, :1], depth[:, :1], K, P[:, :1], device="cuda")
    full = pointclouds_from_rgbdimages(frames[:, 0], filter_missing_depths=False)
    M = full.points.shape[1]
    # one timed call (two took 10.7948 and 10.7952 s, PERF.md §6 PR 8-15)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = knn_points(full.points, full.points, K=KNN_K, tgt_mask=full.nonpad_mask)
    torch.cuda.synchronize()
    full_s = time.perf_counter() - t0
    knn_peak = torch.cuda.max_memory_allocated()
    rows = torch.from_numpy(np.random.RandomState(0).choice(M, KNN_BRUTE_ROWS, replace=False))
    rows = torch.sort(rows).values.cuda()
    d = brute(full.points[:, rows], full.points)[0]
    ref = torch.sort(d, dim=-1, stable=True).indices[:, :KNN_K]  # ties to the smallest index
    ties_full = near_tie_rows(res.idx[0, rows].long(), ref, rows.tolist(), full.points)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    est = estimate_normals(full, k=KNN_K - 1)
    torch.cuda.synchronize()
    normals_s = time.perf_counter() - t0
    cos = torch.abs(torch.sum(est.normals[0].reshape(H, W, 3)
                              * frames.global_normal_map[0, 0], -1))
    inner = cos[KNN_BORDER:-KNN_BORDER, KNN_BORDER:-KNN_BORDER]
    within = float((inner > math.cos(math.radians(KNN_NORMAL_DEG))).double().mean())
    if not within >= KNN_NORMAL_MIN:
        raise AssertionError(f"estimate_normals: within {KNN_NORMAL_DEG} deg of the frame's "
                             f"normals on {within} of interior pixels")
    log(f"knn_points K={KNN_K} on frame 0's full cloud (N = M = {M}): "
        f"{full_s:.4f} s a call (one call), peak {knn_peak} B; "
        f"{KNN_BRUTE_ROWS} sampled rows' K sets equal to a brute-force row's on "
        f"{KNN_BRUTE_ROWS - ties_full} ({ties_full} differ only at ties within 1e-6); "
        f"estimate_normals(k={KNN_K - 1}) {normals_s:.4f} s, within {KNN_NORMAL_DEG} deg of "
        f"the frame's normal map on {100 * within:.3f}% of interior pixels")
    return ("knn_points_k1_stride4", pts, pts, None)


def semantic_online_phase() -> tuple:
    """The semantic / online / K-NN slice: (1) the SEMANTIC_ROWS, (2) the
    online API, (3) K-NN and estimate_normals, (4) both kernels at the
    slice's new shapes. Returns the 1-NN kernel's new timed shape and the
    scatter kernel's."""
    golden = np.load(SEM_GOLDEN)
    t0 = time.perf_counter()
    calls = {name: semantic_row(name, golden) for name in SEMANTIC_ROWS}
    log(f"semantic rows: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    online_rows()
    log(f"online rows: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    knn_case = knn_rows_check(golden)
    log(f"knn rows: {time.perf_counter() - t0:.2f} s")

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    max_err = check_knn_case(*knn_case)
    knn_row = time_knn(*knn_case[1:], sms, max_sm_clock_hz())
    knn_row["case"] = knn_case[0]
    scatter_shapes = {
        f"features_writeback_F{SEM_F}": calls["gt_scatter"]["into"][1 + SEM_F],
        f"features_writeback_quantized_F{SEM_F}": calls["gt_quantized_scatter"]["into"][2 + SEM_F],
        f"window_compaction_{SEM_SCATTER_CAP}": calls["gt_scatter"]["new"][2 * H * W],
        f"aggregate_append_F{SEM_F}": calls["icpslam_gt"]["into"][1 + SEM_F],
    }
    rows = []
    for name, (table, dest, values, fill) in scatter_shapes.items():
        table = table if isinstance(table, int) else table.contiguous()
        dest, values = dest.contiguous(), values.contiguous()
        k = scatter_kernel(table, dest, values, fill)
        if not torch.equal(int_view(k), int_view(scatter_plain(table, dest, values, fill))):
            raise AssertionError(f"scatter {name}: kernel differs from the plain version")
        size = table if isinstance(table, int) else table.shape[1]
        row_bytes = math.prod(values.shape[2:]) * values.element_size()
        log(f"scatter {name}: into {size} rows, dest {tuple(dest.shape)} {dest.dtype}, values "
            f"{tuple(values.shape)} {values.dtype} ({row_bytes}-byte rows, "
            f"{scatter_cuda.word_bytes(row_bytes)}-byte words), bit-equal to the plain version")
        rows.append(time_scatter(name, table, dest, values, fill))
    return [knn_row], max_err, rows

# The dataset slice: a TUM-format and an ICL-format tree written from a seed
# with the port's PNG encoder, read back by the port's loaders and run
# through its example CLIs (gradslam_torch/examples/), held against the JAX
# package's CPU run of the same trees (tests/port/make_dataset_golden.py).
DS_L, DS_H, DS_W = 30, 480, 640
DS_SEED = 0
TUM_INTRINSICS = (525.0, 525.0, 319.5, 239.5)  # fx, fy, cx, cy (tum.py:84-87)
ICL_INTRINSICS = (481.2, -480.0, 319.5, 239.5)  # ICL's negative fy (icl.py:111-114)
DEPTH_UNITS_PER_M = 5000.0  # TUM's and ICL's 16-bit depth scale
PNG_FILTERS = (4, 1, 2, 3, 0)  # each file's rows cycle through every filter, Paeth first
TUM_SEQUENCE = "rgbd_dataset_freiburg1_smoke"
ICL_TRAJECTORY = "living_room_traj0_frei_png"
ICL_H, ICL_W = ICP_H, ICP_W  # the ICPSLAM cell's size: the loader resizes 640x480
DS_GOLDEN = Path(__file__).resolve().parent / "tests/port/data/dataset_jax_cpu.npz"
DS_COUNT_REL = 0.002  # map within 0.2% of the golden's
DS_ATE_FACTOR = 2.0  # ATE within 2x of the golden's
DS_TRAJ_ATOL = 1e-6  # trajectory.txt read back against the poses
DS_RESUME_AT = 15  # the interrupted online run stops after this many frames
DS_CHECKPOINT_EVERY = 5
# the command lines of the example CLIs (the dataset path is added)
DS_POINTFUSION_ARGS = ["--dataset", "tum", "--height", str(DS_H), "--width", str(DS_W),
                       "--seqlen", str(DS_L), "--batch_size", "1", "--odometry", "gradicp"]
DS_ICPSLAM_ARGS = ["--dataset", "icl", "--height", str(ICL_H), "--width", str(ICL_W),
                   "--seqlen", str(DS_L), "--batch_size", "1", "--odometry", "icp"]
DS_ONLINE_ARGS = ["--height", str(DS_H), "--width", str(DS_W), "--odometry", "gradicp"]
# examples/pointfusion.py's PointFusion arguments at its flag defaults
DS_POINTFUSION_DEFAULTS = dict(
    quantize_colors=False, pyramid=None, robust_loss=None, robust_scale=0.05,
    dist_thresh=None, motion_model="static", normal_pitch=None, odom_assoc="knn",
    odom_sym_normals=False, odom_point_weight=0.0, odom_subpixel=False,
    odom_angle_gate=None, relocalize_below=0.0, anchor_every=0, prune_every=0,
    prune_min_confidence=1.5,
)
DS_DIR = "_dataset_smoke"  # the trees and the CLIs' outputs, removed after the phase
# What the numpy decoder, which the frame decoder's C++ library replaced,
# measured on the card's host (PERF.md §6; NVIDIA H100 80GB HBM3, 700.00 W),
# printed beside this run's numbers
EARLIER_HOST = {
    "decode": "the numpy decoder 38.4-68.5 ms a 640x480 PNG",
    "serial": "the numpy decoder 103.6-117.0 ms",
    "pool": "the numpy decoder on 8 processes 29.4-35.6 ms",
    "native": "9.09 / 7.37 s on the numpy decoder's processes",
    "cv2": "3.86 / 2.88 s on the numpy decoder",
    "cli": "6.49 s wall, 3.66 s of it decoding, on the numpy decoder",
}
LOADER_THREADS = (4, 8)  # FrameLoader: the JAX constructor's default, and one a core


def dataset_clip(intrinsics: tuple, shape: tuple = None, seed: int = DS_SEED) -> tuple:
    """The wall and camera path of ``synthetic_sequence`` rendered over
    ``shape = (L, H, W)`` (default ``(DS_L, DS_H, DS_W)``) at ``intrinsics`` ``(fx, fy, cx, cy)`` given for
    640x480 and scaled to ``W x H`` as the loaders scale them, as a sensor
    records it: ``(colors (L, H, W, 3) uint8, depths (L, H, W) uint16 in
    1/5000 m, poses (L, 4, 4) float32)``."""
    L_, H_, W_ = (DS_L, DS_H, DS_W) if shape is None else shape
    sx, sy = W_ / 640.0, H_ / 480.0
    fx, fy, cx, cy = (v * r for v, r in zip(intrinsics, (sx, sy, sx, sy)))
    rng = np.random.RandomState(seed)
    cam_ts = [(0.005 * s, 0.002 * s) for s in range(L_)]
    depths = np.stack([
        synthetic_module._render_depth(H_, W_, fx, cx, cy, tx, tz, fy=fy)
        + 0.0002 * rng.rand(H_, W_) for tx, tz in cam_ts])
    depths = np.round(depths * DEPTH_UNITS_PER_M).astype(np.uint16)
    colors = (rng.rand(L_, H_, W_, 3) * 256).astype(np.uint8)
    poses = synthetic_module._pan_poses(cam_ts, 1)[0]
    return colors, depths, poses


def tum_line(stamp: float, pose: np.ndarray) -> str:
    """One ``t tx ty tz qx qy qz qw`` row of a pure-translation pose."""
    tx, ty, tz = (float(v) for v in pose[:3, 3])
    return f"{stamp:.6f} {tx:.9f} {ty:.9f} {tz:.9f} 0 0 0 1"


def write_tum_tree(root: Path, clip: tuple) -> Path:
    """A TUM sequence directory under ``root``: ``rgb/`` and ``depth/`` PNGs,
    ``rgb.txt``, ``depth.txt`` with each depth stamp 1-15 ms after its rgb
    stamp (inside the 0.02 s association gate, as
    ``tests/datasets/test_long_sequence.py`` jitters them) and
    ``groundtruth.txt``. Returns ``root``."""
    colors, depths, poses = clip
    seq = root / TUM_SEQUENCE
    (seq / "rgb").mkdir(parents=True)
    (seq / "depth").mkdir()
    rng = np.random.RandomState(DS_SEED + 1)
    rgb_lines, depth_lines, gt_lines = ["# rgb"], ["# depth"], ["# timestamp tx ty tz qx qy qz qw"]
    for i in range(len(colors)):
        t = 1000.0 + 0.05 * i
        td = t + 0.001 + 0.014 * rng.rand()
        frameio.write_png(str(seq / "rgb" / f"{t:.6f}.png"), colors[i], filters=PNG_FILTERS)
        frameio.write_png(str(seq / "depth" / f"{td:.6f}.png"), depths[i], filters=PNG_FILTERS)
        rgb_lines.append(f"{t:.6f} rgb/{t:.6f}.png")
        depth_lines.append(f"{td:.6f} depth/{td:.6f}.png")
        gt_lines.append(tum_line(t + 0.002, poses[i]))
    (seq / "rgb.txt").write_text("\n".join(rgb_lines) + "\n")
    (seq / "depth.txt").write_text("\n".join(depth_lines) + "\n")
    (seq / "groundtruth.txt").write_text("\n".join(gt_lines) + "\n")
    return root


def write_icl_tree(root: Path, clip: tuple) -> Path:
    """An ICL trajectory directory under ``root``: ``rgb/``, ``depth/``,
    ``associations.txt`` and ``livingRoom0.gt.freiburg``. Returns ``root``."""
    colors, depths, poses = clip
    traj = root / ICL_TRAJECTORY
    (traj / "rgb").mkdir(parents=True)
    (traj / "depth").mkdir()
    assoc, gt = [], []
    for i in range(len(colors)):
        frameio.write_png(str(traj / "rgb" / f"{i}.png"), colors[i], filters=PNG_FILTERS)
        frameio.write_png(str(traj / "depth" / f"{i}.png"), depths[i], filters=PNG_FILTERS)
        assoc.append(f"{i} depth/{i}.png {i} rgb/{i}.png")
        gt.append(tum_line(float(i), poses[i]))
    (traj / "associations.txt").write_text("\n".join(assoc) + "\n")
    (traj / "livingRoom0.gt.freiburg").write_text("\n".join(gt) + "\n")
    return root


def decoded_arrays(clip: tuple, intrinsics: tuple, native: bool = False) -> tuple:
    """The clip as the TUM loader hands it over at the clip's own size,
    made in memory: ``(rgb (1, L, H, W, 3), depth (1, L, H, W, 1), K (1, 1,
    4, 4), poses (1, L, 4, 4))`` float32, ``intrinsics`` (for 640x480)
    scaled as the loader scales them; depth divided by the scale, as the
    ``'cv2'`` loader does, or with ``native`` times ``1.0f / scale``, as the
    ``'native'`` loader does (the JAX package's native library's
    arithmetic)."""
    colors, depths, poses = clip
    fx, fy, cx, cy = intrinsics
    K = np.eye(4, dtype=np.float32)
    K[0, 0], K[1, 1], K[0, 2], K[1, 2] = fx, fy, cx, cy
    K = scale_intrinsics(K, depths.shape[1] / 480.0, depths.shape[2] / 640.0)
    depth = depths.astype(np.float32)[..., None]
    depth = (depth * (np.float32(1) / np.float32(DEPTH_UNITS_PER_M)) if native
             else depth / DEPTH_UNITS_PER_M)
    rebased = (np.linalg.inv(poses[0:1]) @ poses).astype(np.float32)
    return colors.astype(np.float32)[None], depth[None], K[None, None], rebased[None]


def dataset_launches(kind: str) -> dict:
    """Both kernels' launches of one run of a dataset-phase CLI, derived
    from the code: the TUM pointfusion run as :func:`recovery_launches`
    derives a gradICP PointFusion run at the default capacity L * H * W
    (fusion windowed + scatter there); the ICL icpslam run as ICPSLAM flat
    (``SCATTER_LAUNCHES``), with ``odom='icp'``'s 20 LM iterations of two
    searches each."""
    if kind == "tum":
        kw = dict(odom="gradicp", map_capacity=DS_L * DS_H * DS_W)
        return recovery_launches(kw, (1, DS_L, DS_H, DS_W), {"relocalize": [], "anchor": []})
    return {"knn": 2 * 20 * (DS_L - 1), "scatter": 3 + (DS_L - 1) * ((2 + 3) + 3)}


def decode_times(path: Path, image: np.ndarray) -> dict:
    """Host ms to decode one frame (median of 5): the file as written (rows
    cycling through ``PNG_FILTERS``), read from disk and decoded; its bytes
    decoded from memory, by the library and by the plain numpy codec; and
    the same image encoded with every row Paeth or every row Sub (the plain
    codec's fast row path), decoded from memory by the library."""
    data = path.read_bytes()
    cases = {"file": lambda: frameio.read_png(str(path)),
             "as_written": lambda: frameio.decode_png(data),
             "plain": lambda: frameio.decode_png_plain(data)}
    for name, filt in (("paeth", 4), ("sub", 1)):
        encoded = frameio.encode_png(image, filters=filt)
        cases[name] = lambda encoded=encoded: frameio.decode_png(encoded)
    out = {}
    for name, fn in cases.items():
        got = fn()
        if not (got.dtype == image.dtype and np.array_equal(got, image)):
            raise AssertionError(f"PNG {path.name} ({name}) decodes to another image")
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            fn()
            times.append(1e3 * (time.perf_counter() - t0))
        out[name] = float(np.median(times))
    return out


def decode_equals_plain(roots) -> int:
    """Every PNG under ``roots`` decoded by the library and by the plain
    numpy codec: the same dtype, shape and samples (raises otherwise).
    Returns the number of files."""
    n = 0
    for root in roots:
        for path in sorted(Path(root).rglob("*.png")):
            data = path.read_bytes()
            got, want = frameio.decode_png(data), frameio.decode_png_plain(data)
            if not (got.dtype == want.dtype and got.shape == want.shape
                    and np.array_equal(got, want)):
                raise AssertionError(f"{path}: the library's decode differs from the plain "
                                     "codec's")
            n += 1
    return n


def new_children(before: set) -> set:
    """Live processes below this one that were not in ``before``."""
    import multiprocessing

    return (set(_descendants(os.getpid())) - before) | {
        p.pid for p in multiprocessing.active_children()}


class LoadTimer:
    """Seconds a dataset spends loading its samples' frames (reading,
    decoding, resizing, stacking: ``RGBDSequenceDataset._load_frames``)
    while the context is open."""

    def __enter__(self):
        self.seconds, real = 0.0, base_module.RGBDSequenceDataset._load_frames
        self._real = real

        def timed(ds, sample):
            t0 = time.perf_counter()
            try:
                return real(ds, sample)
            finally:
                self.seconds += time.perf_counter() - t0

        base_module.RGBDSequenceDataset._load_frames = timed
        return self

    def __exit__(self, *exc):
        base_module.RGBDSequenceDataset._load_frames = self._real


def counted(fn):
    """``fn()`` with both kernels' counts set to 0 just before and read just
    after, timed on the host clock. Returns ``(result, launches, seconds)``."""
    torch.cuda.synchronize()
    knn_cuda.launches = scatter_cuda.launches = 0
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return out, {"knn": knn_cuda.launches, "scatter": scatter_cuda.launches}, secs


def dataset_phase() -> tuple:
    """The dataset slice (``gradslam_torch/datasets``, ``structures/io.py``,
    ``utils/``, ``examples/``), from disk to disk at 640x480x30:

    (1) write the TUM and ICL trees (``write_tum_tree``, ``write_icl_tree``)
        and time the host's PNG decode of one colour and one depth frame and
        the load of the 30-frame sample (both loaders, equal tensors);
    (2) ``examples.pointfusion.main`` on the TUM tree (gradICP, the default
        capacity, fusion modes ``'auto'``): map within 0.2% of the JAX
        golden, 0 dropped, unaligned ATE within 2x the golden's, and poses,
        map and both kernels' launches equal to the in-memory run of the
        same frames (``decoded_arrays`` -> interop -> PointFusion);
    (3) ``examples.icpslam.main`` on the ICL tree resized to 320x240: the
        map exactly the valid pixel count, aligned ATE within 2x the
        golden's;
    (4) ``examples.online_slam.main`` on the TUM tree through 30 frames
        (checkpoints every 5), through 15, then resumed to 30: the resumed
        run's poses and map SHA-256-equal to the uninterrupted run's, its
        ``map.ply`` read back equal to the map's live rows, its
        ``trajectory.txt`` within ``DS_TRAJ_ATOL`` of the poses;
    (5) both kernels against their plain versions on the inputs of (2).

    Returns the 1-NN kernel's new timed shape, its max error and the scatter
    kernel's new timed shapes."""
    golden = np.load(DS_GOLDEN)
    root = Path(__file__).resolve().parent / DS_DIR
    shutil.rmtree(root, ignore_errors=True)
    try:
        return _dataset_phase(root, golden)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _dataset_phase(root: Path, golden) -> tuple:
    # (1) the trees, the decoder's and the loaders' host times
    t0 = time.perf_counter()
    tum_clip = dataset_clip(TUM_INTRINSICS)
    icl_clip = dataset_clip(ICL_INTRINSICS)
    tum_root = write_tum_tree(root / "tum", tum_clip)
    icl_root = write_icl_tree(root / "icl", icl_clip)
    log(f"dataset: rendered and wrote the TUM and ICL trees ({2 * DS_L} frames each at "
        f"{DS_W}x{DS_H}, rows cycling through PNG filters {PNG_FILTERS}) in "
        f"{time.perf_counter() - t0:.2f} s")
    seq = tum_root / TUM_SEQUENCE
    t0 = time.perf_counter()
    checked = decode_equals_plain((tum_root, icl_root))
    log(f"dataset: the library's decode bit-equal to the plain numpy codec on all {checked} "
        f"PNG files of the TUM and ICL trees ({time.perf_counter() - t0:.2f} s)")
    rgb0 = sorted((seq / "rgb").iterdir())[0]
    depth0 = sorted((seq / "depth").iterdir())[0]
    color_ms = decode_times(rgb0, tum_clip[0][0])
    depth_ms = decode_times(depth0, tum_clip[1][0])
    log(f"dataset: host PNG decode ms a {DS_W}x{DS_H} frame (median of 5; the library unless "
        "'plain'): colour " + ", ".join(f"{k} {v:.3f}" for k, v in color_ms.items())
        + "; depth " + ", ".join(f"{k} {v:.3f}" for k, v in depth_ms.items())
        + f"; a colour and depth pair from disk {color_ms['file'] + depth_ms['file']:.3f} ms "
        f"(earlier: {EARLIER_HOST['decode']})")
    before = set(_descendants(os.getpid()))
    loads = {}
    for loader in ("cv2", "native"):
        t0 = time.perf_counter()
        sample = TUM(str(tum_root), seqlen=DS_L, height=DS_H, width=DS_W, loader=loader)[0]
        loads[loader] = (time.perf_counter() - t0, sample)
    if new_children(before):
        raise AssertionError(f"dataset: the loaders left processes {new_children(before)}")
    # the 'cv2' sample is the arrays written, divided by the depth scale; the
    # 'native' one the same colours with depth times 1.0f / scale
    want = decoded_arrays(tum_clip, TUM_INTRINSICS)
    want_native = decoded_arrays(tum_clip, TUM_INTRINSICS, native=True)
    for loader, ref in (("cv2", want), ("native", want_native)):
        for got, arr in zip(loads[loader][1][:4], (ref[0][0], ref[1][0], ref[2][0, 0], ref[3][0])):
            if not (got.dtype == torch.float32 and np.array_equal(got.numpy(), arr)):
                raise AssertionError(f"dataset: the {loader!r} TUM sample differs from the "
                                     "arrays written")
    ulps = int((loads["cv2"][1][1] != loads["native"][1][1]).sum())
    log(f"dataset: TUM sample of {DS_L} frames ({2 * DS_L} PNGs) loaded in "
        f"{loads['cv2'][0]:.3f} s (loader 'cv2', one after the other; earlier "
        f"{EARLIER_HOST['cv2']}) and {loads['native'][0]:.3f} s (loader 'native', "
        f"{min(DS_L, os.cpu_count())} threads; earlier {EARLIER_HOST['native']}); each equal "
        f"to the arrays written under its own depth arithmetic (colours equal, {ulps} depths "
        "one float32 ulp apart); no process started")

    # (2) pointfusion on the TUM tree, held against the golden and the
    # in-memory run of the same frames
    cap = DS_L * DS_H * DS_W
    modes = _resolve_modes("auto", "auto", cap, DS_H * DS_W, min(2 * DS_H * DS_W, cap))
    log(f"dataset: pointfusion at the default capacity {cap}: 'auto' fuses {modes[0]} + "
        f"{modes[1]}")
    argv = DS_POINTFUSION_ARGS + ["--dataset_path", str(tum_root)]
    with (KnnCapture() as knn_cap, ScatterCapture() as new_cap, ScatterIntoCapture() as into_cap,
          LoadTimer() as load_timer):
        (pc, poses), cli_launches, cli_s = counted(lambda: pointfusion_example.main(argv))
    expect = dataset_launches("tum")
    LAUNCHES["dataset_tum_pointfusion"] = cli_launches
    if cli_launches != expect:
        raise AssertionError(f"dataset pointfusion: launches {cli_launches}, expected {expect}")
    count = int(pc.num_points[0])
    ref = int(golden["tum_num_points"])
    if int(pc.num_dropped[0]) != 0 or abs(count - ref) > DS_COUNT_REL * ref:
        raise AssertionError(f"dataset pointfusion: map {count} ({int(pc.num_dropped[0])} "
                             f"dropped), JAX golden {ref}")
    check_run(pc, poses, (1, DS_L), "dataset pointfusion")
    ate = ate_m(poses[0].cpu().numpy(), tum_clip[2])
    bar = DS_ATE_FACTOR * float(golden["tum_ate_unaligned_m"])
    if not ate <= bar:
        raise AssertionError(f"dataset pointfusion: unaligned ATE {ate} m above {bar} m")
    slam = PointFusion(odom="gradicp", **DS_POINTFUSION_DEFAULTS)
    runs = {}
    for tag, arrays in (("memory", want), ("native", tuple(
            np.asarray(x)[None] for x in loads["native"][1][:4])), ("memory_native", want_native)):
        if tag == "native":
            arrays = (arrays[0], arrays[1], arrays[2][None], arrays[3])
        frames = rgbdimages_from_numpy(*arrays, device="cuda")
        runs[tag] = counted(lambda frames=frames: slam(frames))
        LAUNCHES[f"dataset_tum_{tag}"] = runs[tag][1]
        if runs[tag][1] != cli_launches:
            raise AssertionError(f"dataset pointfusion: {tag} run's launches {runs[tag][1]}, "
                                 f"the CLI's {cli_launches}")
    digest = map_digest(pc, poses)
    digests = {tag: map_digest(*run[0]) for tag, run in runs.items()}
    if digests["memory"] != digest:
        raise AssertionError("dataset pointfusion: poses or map differ from the in-memory run")
    if digests["native"] != digests["memory_native"]:
        raise AssertionError("dataset pointfusion: the 'native' sample's poses or map differ "
                             "from the in-memory run of the native arithmetic")
    (pc_n, poses_n), _, native_s = runs["native"]
    check_run(pc_n, poses_n, (1, DS_L), "dataset pointfusion (native sample)")
    gap = float((poses_n - poses).abs().max())
    log(f"dataset: pointfusion CLI on the TUM tree {DS_W}x{DS_H}x{DS_L}: wall {cli_s:.3f} s, "
        f"{load_timer.seconds:.3f} s of it loading the sample (loader 'cv2'; earlier "
        f"{EARLIER_HOST['cli']}); the in-memory run {runs['memory'][2]:.3f} s = "
        f"{DS_L / runs['memory'][2]:.4f} frames/s; map {count} points (JAX golden {ref}), 0 "
        f"dropped, unaligned ATE {ate:.4e} m (bar {bar:.4e} m), launches {cli_launches} in "
        f"every run, SHA-256 of poses and map equal to the in-memory run's ({digest[:16]}); "
        f"the 'native' sample's run ({native_s:.3f} s) SHA-256-equal to the in-memory run of "
        f"the native arithmetic ({digests['native'][:16]}), "
        + ("equal to the 'cv2' run too" if digests["native"] == digest else
           f"apart from the 'cv2' run by its {ulps} depth ulps: map {int(pc_n.num_points[0])} "
           f"points against {count}, poses within {gap:.3e}"))

    # (3) icpslam on the ICL tree, resized to the ICPSLAM cell's size
    argv = DS_ICPSLAM_ARGS + ["--dataset_path", str(icl_root)]
    (ipc, iposes), icl_launches, icl_s = counted(lambda: icpslam_example.main(argv))
    LAUNCHES["dataset_icl_icpslam"] = icl_launches
    if icl_launches != dataset_launches("icl"):
        raise AssertionError(f"dataset icpslam: launches {icl_launches}, expected "
                             f"{dataset_launches('icl')}")
    valid = int((base_module.resize_nearest(icl_clip[1].transpose(1, 2, 0), ICL_H, ICL_W)
                 > 0).sum())
    icount = check_run(ipc, iposes, (1, DS_L), "dataset icpslam")
    if icount != valid or icount != int(golden["icl_num_points"]):
        raise AssertionError(f"dataset icpslam: map {icount}, valid pixels {valid}, JAX golden "
                             f"{int(golden['icl_num_points'])}")
    iate = float(ate_rmse(iposes[0].cpu(), torch.from_numpy(icl_clip[2])))
    ibar = DS_ATE_FACTOR * float(golden["icl_ate_m"])
    if not iate <= ibar:
        raise AssertionError(f"dataset icpslam: aligned ATE {iate} m above {ibar} m")
    log(f"dataset: icpslam CLI on the ICL tree ({DS_W}x{DS_H} files at {ICL_W}x{ICL_H}) x{DS_L}: "
        f"wall {icl_s:.3f} s; map {icount} points = the valid pixels, 0 dropped, aligned ATE "
        f"{iate:.4e} m (bar {ibar:.4e} m), launches {icl_launches}")

    # (4) online_slam: uninterrupted against checkpoint + resume
    common = DS_ONLINE_ARGS + ["--dataset_path", str(tum_root)]
    whole, split = str(root / "online_whole"), str(root / "online_split")
    runs = {}
    for tag, extra in (("whole", ["--seqlen", str(DS_L), "--checkpoint-every",
                                  str(DS_CHECKPOINT_EVERY), "--out", whole]),
                       ("first", ["--seqlen", str(DS_RESUME_AT), "--out", split]),
                       ("resumed", ["--seqlen", str(DS_L), "--resume", "--out", split])):
        runs[tag] = counted(lambda extra=extra: online_example.main(common + extra))
        LAUNCHES[f"dataset_online_{tag}"] = runs[tag][1]
    (opc, oest), olaunches, osecs = runs["whole"]
    (rpc, rest), _, _ = runs["resumed"]
    digest = map_digest(opc, oest)
    if map_digest(rpc, rest) != digest or not torch.equal(rpc.num_dropped, opc.num_dropped):
        raise AssertionError("dataset online_slam: the resumed run differs from the "
                             "uninterrupted one")
    halves = {k: runs["first"][1][k] + runs["resumed"][1][k] for k in olaunches}
    if halves != olaunches or olaunches != cli_launches:
        raise AssertionError(f"dataset online_slam: launches {olaunches} uninterrupted, "
                             f"{halves} in two parts, {cli_launches} for forward")
    n = int(opc.num_points[0])
    cloud = load_ply(f"{whole}/map.ply")
    if not (np.array_equal(cloud["points"], opc.points[0, :n].cpu().numpy())
            and np.array_equal(cloud["normals"], opc.normals[0, :n].cpu().numpy())):
        raise AssertionError("dataset online_slam: map.ply differs from the map's live rows")
    _, traj = load_trajectory_tum(f"{whole}/trajectory.txt")
    traj_err = float(np.abs(traj - oest.cpu().numpy()).max())
    if not traj_err <= DS_TRAJ_ATOL:
        raise AssertionError(f"dataset online_slam: trajectory.txt off by {traj_err}")
    log(f"dataset: online_slam CLI {DS_W}x{DS_H}x{DS_L}: wall {osecs:.3f} s uninterrupted "
        f"(checkpoints every {DS_CHECKPOINT_EVERY}), {runs['first'][2]:.3f} s to frame "
        f"{DS_RESUME_AT} and {runs['resumed'][2]:.3f} s resumed to {DS_L}; the resumed run "
        f"SHA-256-equal to the uninterrupted one ({digest[:16]}), launches "
        f"{olaunches} = forward's; map.ply ({n} points) equal to the map's live rows, "
        f"trajectory.txt within {traj_err:.2e} of the poses")

    # (5) both kernels against their plain versions on (2)'s own inputs
    src, tgt, mask = knn_cap.args
    max_err = check_knn_case("dataset_tum_first_search", src, tgt, mask)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    knn_row = time_knn(src, tgt, mask, sms, max_sm_clock_hz())
    knn_row["case"] = "dataset_tum_first_search"
    checked = []
    for kind, calls in (("new table", new_cap.calls), ("into buffer", into_cap.calls)):
        for key, (table, dest, values, fill) in calls.items():
            table = table if isinstance(table, int) else table.contiguous()
            args = (table, dest.contiguous(), values.contiguous(), fill)
            if not torch.equal(int_view(scatter_kernel(*args)), int_view(scatter_plain(*args))):
                raise AssertionError(f"dataset scatter ({kind} {key}): the kernel differs from "
                                     "its plain version")
            checked.append(f"{kind} {key}")
    log("dataset: the 1-NN kernel on the run's first search and the scatter kernel on the "
        "run's last call of each kind bit-equal to their plain versions: " + ", ".join(checked))
    rows = []
    width = max(into_cap.calls)  # the scatter merge's map rows
    for name, (table, dest, values, fill) in (
            (f"dataset_merge_{width}f_into_{cap}", into_cap.calls[width]),
            (f"dataset_window_{2 * DS_H * DS_W}", new_cap.calls[2 * DS_H * DS_W])):
        table = table if isinstance(table, int) else table.contiguous()
        rows.append(time_scatter(name, table, dest.contiguous(), values.contiguous(), fill))
    return [knn_row], max_err, rows


# The dense reference fusion path (find_correspondences + fuse_with_map) on
# the easy clip with gt poses and the gt path's schedule, and the structure
# API at full width (structures_phase).
DENSE_DIST_TH, DENSE_DOT_TH, DENSE_SIGMA = 0.05, math.cos(math.radians(20)), 0.6
DENSE_SCATTERS_PER_FRAME = 4  # append_masked: points, normals, colors, features
DENSE_ATOL = 1e-5  # lockstep: the dense map's live rows against sort_full's
DENSE_MASS_RTOL = 1e-5
DENSE_GT_REL = 0.002  # the dense run's count against the gt pipeline's map
STRUCT_ATOL = 1e-5  # a structure op on the card against the same op on the CPU
STRUCT_PIX_RTOL = 1e-6  # pinhole projections, in pixels: also within this of their size


class ScatterIntoTail:
    """Keeps the last ``n`` scatter calls into a buffer made while it is
    active (the kernel still runs): after a dense run, its last frame's
    append, one call a buffer."""

    def __init__(self, n: int):
        self.n, self.calls = n, []

    def __enter__(self):
        self._real = pointclouds_module._scatter_rows_into

        def spy(buf, dest, values):
            self.calls = (self.calls + [(buf, dest, values, 0)])[-self.n:]
            return self._real(buf, dest, values)

        pointclouds_module._scatter_rows_into = spy
        return self

    def __exit__(self, *exc):
        pointclouds_module._scatter_rows_into = self._real


def dense_step(pc, frame):
    """One frame of the dense chain as a user calls it."""
    active, winner, corr = find_correspondences(pc, frame, DENSE_DIST_TH, DENSE_DOT_TH)
    return fuse_with_map(pc, frame, active, winner, corr, DENSE_SIGMA)


def dense_run(frames, step=dense_step):
    """``step`` over the clip at the gt path's capacity schedule
    (``with_capacity`` between segments)."""
    pc = Pointclouds.empty(B, SCHEDULE[0][1], device=frames.device)
    s = 0
    for n, cap in SCHEDULE:
        pc = pc.with_capacity(cap)
        for _ in range(n):
            pc, s = step(pc, frames[:, s]), s + 1
    return pc


def live_mass(pc) -> float:
    return float((pc.features[0, :int(pc.num_points[0])].double()).sum())


class DenseLockstep:
    """A dense step held against the fast path from the same map:
    ``update_map_fusion(association='sort_full')`` (every map row gated:
    exact, nothing overflows) against ``find_similar_map_points``,
    ``find_best_unique_correspondences`` and ``fuse_with_map`` given the
    fast path's own projection (``_project_map_points``).

    ``find_active_map_points`` (the dense chain's projection, as in the JAX
    package) and ``_project_map_points`` compute the same pixel with other
    float32 roundings, as their JAX counterparts do, so a map point within
    an ulp of a pixel's edge lands on a neighbour in one of them; the
    lockstep gives both paths one projection and counts those rows
    (``flips``). Held: equal counts; the live rows within ``DENSE_ATOL`` row
    for row (both merge in place and append in pixel order) and column by
    column sorted (the form of JAX's ``test_windowed_equals_dense``); the
    confidence mass within ``DENSE_MASS_RTOL``."""

    def __init__(self):
        self.worst, self.flips, self.frames = {}, [], 0

    def __call__(self, pc, frame):
        _, _, H_, W_ = frame.shape
        valid, pix = _project_map_points(pc.points, pc.nonpad_mask, frame.poses[:, 0],
                                         frame.intrinsics[:, 0], H_, W_)
        active = ActiveMapPoints(valid=valid, pix_h=pix // W_, pix_w=pix % W_)
        own = find_active_map_points(pc, frame)
        own_pix = own.pix_h * W_ + own.pix_w
        self.flips.append(int(((own.valid != valid) | (valid & (own_pix != pix))).sum()))
        similar = find_similar_map_points(pc, frame, active, DENSE_DIST_TH, DENSE_DOT_TH)
        winner, corr = find_best_unique_correspondences(pc, frame, active, similar)
        dense = fuse_with_map(pc, frame, active, winner, corr, DENSE_SIGMA)
        fast = update_map_fusion(pc, frame, DENSE_DIST_TH, DENSE_DOT_TH, DENSE_SIGMA,
                                 association="sort_full")
        s = self.frames
        if not (torch.equal(fast.num_points, dense.num_points)
                and torch.equal(fast.num_dropped, dense.num_dropped)):
            raise AssertionError(f"dense lockstep frame {s}: counts {fast.num_points.tolist()} "
                                 f"(sort_full) against {dense.num_points.tolist()} (dense)")
        n = int(dense.num_points[0])
        for name in ("points", "normals", "colors", "features"):
            f, d = getattr(fast, name)[0, :n], getattr(dense, name)[0, :n]
            rows = float((f - d).abs().max()) if n else 0.0
            cols = (float((torch.sort(f, 0).values - torch.sort(d, 0).values).abs().max())
                    if n else 0.0)
            self.worst[name] = max(self.worst.get(name, 0.0), rows, cols)
            if not max(rows, cols) <= DENSE_ATOL:
                raise AssertionError(f"dense lockstep frame {s}: {name} {rows} row for row, "
                                     f"{cols} sorted, above {DENSE_ATOL}")
        mass_f, mass_d = live_mass(fast), live_mass(dense)
        rel = abs(mass_f - mass_d) / max(abs(mass_d), 1e-30)
        self.worst["mass_rel"] = max(self.worst.get("mass_rel", 0.0), rel)
        if not rel <= DENSE_MASS_RTOL:
            raise AssertionError(f"dense lockstep frame {s}: confidence mass {mass_f} "
                                 f"(sort_full) against {mass_d} (dense)")
        self.frames += 1
        return dense


def pointclouds_equal(a, b) -> bool:
    return all(
        (getattr(a, n) is None and getattr(b, n) is None)
        or torch.equal(getattr(a, n).cpu(), getattr(b, n).cpu())
        for n in ("points", "num_points", "normals", "colors", "features", "num_dropped"))


def cloud_sha256(pc) -> str:
    return sha256_of(*[t for t in (pc.points, pc.num_points, pc.normals, pc.colors,
                                   pc.features, pc.num_dropped) if t is not None])


def check_structure_op(tag, card, cpu, n_live) -> dict:
    """A structure op's result on the card against the same op on the CPU:
    points and normals within ``STRUCT_ATOL`` (a projection's pixels also
    within ``STRUCT_PIX_RTOL`` of their size), the other buffers and the
    counters equal, the padding rows' points exactly zero."""
    gaps = {}
    for name in ("points", "normals"):
        c, h = getattr(card, name), getattr(cpu, name)
        if c is None:
            continue
        c = c.cpu()
        gap = (c - h).abs()
        bar = STRUCT_ATOL + (STRUCT_PIX_RTOL * h.abs() if "projection" in tag else 0.0)
        gaps[name] = float(gap.max())
        if not bool((gap <= bar).all()):
            raise AssertionError(f"structures {tag}: {name} {gaps[name]} from the CPU's")
    for name in ("colors", "features", "num_points", "num_dropped"):
        if not (getattr(card, name) is None and getattr(cpu, name) is None) and not torch.equal(
                getattr(card, name).cpu(), getattr(cpu, name)):
            raise AssertionError(f"structures {tag}: {name} differs from the CPU's")
    for b, n in enumerate(n_live):
        if bool((card.points[b, n:] != 0).any()):
            raise AssertionError(f"structures {tag}: padding rows of cloud {b} are not zero")
    return gaps


def structure_api_phase(pc_gt, frames) -> None:
    """(c) The structure API at full width on the gt map: each op on the
    card against the same op on a CPU copy; the ``*_`` names leave their
    input's SHA-256 unchanged; indexing, the tensor round trips and
    ``from_list`` exact; ``RGBDImages`` at 640x480; the device time of
    ``transform``."""
    cpu = pc_gt.cpu()
    n = int(pc_gt.num_points[0])
    digest = cloud_sha256(pc_gt)
    gen = torch.Generator().manual_seed(0)
    xi = torch.cat([torch.randn(2, 3, generator=gen) * 0.3, torch.randn(2, 3, generator=gen) * 0.5], 1)
    T2 = se3_exp(xi)  # (2, 4, 4) on the CPU; row 0 is the unbatched transform
    args = {"T": T2[0], "T batched": T2[:1], "R": T2[0, :3, :3], "R batched": T2[:1, :3, :3],
            "K": frames.intrinsics[0, 0].cpu(), "o": torch.tensor([0.1, -0.2, 0.3]),
            "s": torch.tensor([1.5, 0.5, 2.0])}
    ops = {
        "transform": lambda p, a: p.transform(a["T"]),
        "transform batched": lambda p, a: p.transform(a["T batched"]),
        "transform post-multiplied": lambda p, a: p.transform(a["T"], pre_multiplication=False),
        "rotate": lambda p, a: p.rotate(a["R"]),
        "rotate batched": lambda p, a: p.rotate(a["R batched"]),
        "offset": lambda p, a: p.offset(a["o"]),
        "scale": lambda p, a: p.scale(a["s"]),
        "pinhole_projection": lambda p, a: p.pinhole_projection(a["K"]),
        "@ R": lambda p, a: p @ a["R"],
        "@ T batched": lambda p, a: p @ a["T batched"],
        "+ -": lambda p, a: (p + a["o"]) - a["o"] * 2,
        "* /": lambda p, a: (p * a["s"]) / 4.0,
        "transform_": lambda p, a: p.transform_(a["T"]),
        "rotate_": lambda p, a: p.rotate_(a["R"]),
        "offset_": lambda p, a: p.offset_(a["o"]),
        "scale_": lambda p, a: p.scale_(a["s"]),
        "pinhole_projection_": lambda p, a: p.pinhole_projection_(a["K"]),
    }
    card_args = {k: v.cuda() for k, v in args.items()}
    gaps = {}
    for tag, op in ops.items():
        gaps[tag] = check_structure_op(tag, op(pc_gt, card_args), op(cpu, args), [n])
    if cloud_sha256(pc_gt) != digest:
        raise AssertionError("structures: an op changed its input map")
    worst = {k: max(g.get(k, 0.0) for g in gaps.values()) for k in ("points", "normals")}

    # indexing on a B=2 cloud, from_list and the tensor round trips
    pts, nrm, col, feat = (pc_gt.points_list[0], pc_gt.normals_list[0], pc_gt.colors_list[0],
                           pc_gt.features_list[0])
    back = Pointclouds.from_list([pts], normals=[nrm], colors=[col], features=[feat],
                                 capacity=pc_gt.capacity)
    if back.device != pc_gt.device or back.num_points.dtype != torch.int64 or not all(
            torch.equal(getattr(back, f), getattr(pc_gt, f))
            for f in ("points", "num_points", "normals", "colors", "features")):
        raise AssertionError("structures: from_list(points_list, ...) differs from the map")
    half = n // 2
    two = Pointclouds.from_list([pts, pts[:half]], normals=[nrm, nrm[:half]],
                                capacity=pc_gt.capacity)
    two_cpu = two.cpu()
    for index in (0, 1, -1, -2, slice(0, 1), slice(1, None), slice(None)):
        sub, sub_cpu = two[index], two_cpu[index]
        if not pointclouds_equal(sub, sub_cpu) or sub.device != pc_gt.device:
            raise AssertionError(f"structures: [{index}] differs from the CPU's")
    for index in (2, -3):
        try:
            two[index]
        except IndexError:
            continue
        raise AssertionError(f"structures: [{index}] of 2 clouds did not raise IndexError")
    clone = pc_gt.clone()
    round_trips = {"clone": clone, "detach": pc_gt.detach(), "to('cpu')": pc_gt.to("cpu"),
                   "cpu().cuda()": pc_gt.cpu().cuda()}
    for tag, copy in round_trips.items():
        if not pointclouds_equal(copy, pc_gt):
            raise AssertionError(f"structures: {tag} differs from the map")
    if clone.points.data_ptr() == pc_gt.points.data_ptr() or \
            round_trips["cpu().cuda()"].device != pc_gt.device:
        raise AssertionError("structures: clone shares a buffer, or cuda() left the card")

    # RGBDImages at 640x480
    fr_cpu = frames.cpu()
    for tag, fr in (("clone", frames.clone()), ("to('cpu')", frames.to("cpu")),
                    ("cpu().cuda()", fr_cpu.cuda()), ("detach", frames.detach())):
        if not all(torch.equal(getattr(fr, a).cpu(), getattr(fr_cpu, a))
                   for a in ("rgb_image", "depth_image", "intrinsics", "poses")):
            raise AssertionError(f"structures: RGBDImages {tag} differs")
    cf = frames.to_channels_first()
    for name in ("rgb_image_channels_first", "depth_image_channels_first"):
        ours, theirs = getattr(frames, name), getattr(cf, name)
        if not (torch.equal(ours, theirs) and torch.equal(ours.cpu(), getattr(fr_cpu, name))):
            raise AssertionError(f"structures: RGBDImages {name} differs")
    if frames.rgb_image_channels_first.data_ptr() != frames.rgb_image.data_ptr() or (
            frames.h, frames.w, frames.has_poses) != (H, W, True):
        raise AssertionError("structures: RGBDImages views or shape properties wrong")

    # TF32: a user who allows it still gets float32 products from the
    # structure ops, and finds the flag as it was
    exact = pc_gt.transform(card_args["T"]).points
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        user = pc_gt.transform(card_args["T"]).points
        restored = torch.backends.cuda.matmul.allow_tf32
    finally:
        disable_tf32()
    if not (torch.equal(user, exact) and restored):
        raise AssertionError("structures: transform with TF32 allowed differs, or the flag moved")
    transform_ms = device_ms(lambda: pc_gt.transform(card_args["T"]), 20)
    log(f"structures: {len(ops)} Pointclouds ops on the {n}-point gt map ({pc_gt.capacity} rows) "
        f"against the CPU's: max |dpoint| {worst['points']:.3e}, max |dnormal| "
        f"{worst['normals']:.3e}, padding exactly zero, the input's SHA-256 unchanged by every "
        f"op and *_ name; from_list(points_list) back to the map's rows; indexing [0, 1, -1, -2, "
        f"0:1, 1:, :] of a 2-cloud batch equal to the CPU's, [2] and [-3] IndexError; clone, "
        f"detach, to('cpu'), cpu().cuda() exact; RGBDImages {W}x{H}x{L} clone, to, cuda and the "
        f"channels-first views exact; transform with TF32 allowed bit-equal; transform "
        f"{transform_ms:.4f} ms device time on the card")


def structures_phase(frames, pc_gt, secs_gt) -> list:
    """The structures slice (``structures/``, ``geometry/``, the dense
    fusion path of ``slam/fusionutils.py``) on the 640x480x30 clip:

    (a) with gt poses and the gt schedule, the dense steps in lockstep with
        ``update_map_fusion(association='sort_full')`` from the same map at
        every frame (:class:`DenseLockstep`); then the dense chain as a
        user calls it (``find_correspondences`` + ``fuse_with_map``), two
        timed runs that must launch the scatter kernel
        ``DENSE_SCATTERS_PER_FRAME * L`` times and the 1-NN never, bit-equal
        to each other; the map within 0.2% of the reference's 516,214 with 0
        dropped, and against the gt pipeline's own map (``'auto'`` resolves
        to ``sort_full`` there): counts within 0.2%, the count gap and the
        share of rows within ``DENSE_ATOL`` reported; s/run beside the gt
        fast path's;
    (b) the scatter kernel on the last frame's append (four calls) bit-equal
        to its plain version, timed at the points and the features row;
    (c) :func:`structure_api_phase`.

    TF32 stays off (asserted before and after). Returns the scatter
    kernel's new timed shapes."""
    if not tf32_disabled():
        raise AssertionError("structures: TF32 enabled before the phase")
    L_ = frames.shape[1]
    lock = DenseLockstep()
    with ScatterIntoTail(DENSE_SCATTERS_PER_FRAME) as tail:
        pc_lock = dense_run(frames, lock)
    runs, secs = [], []
    for _ in range(TIMED_RUNS):
        pc_dense, launches, sec = counted(lambda: dense_run(frames))
        runs.append(pc_dense)
        secs.append(sec)
        expect = {"knn": 0, "scatter": DENSE_SCATTERS_PER_FRAME * L_}
        if launches != expect:
            raise AssertionError(f"dense: launches {launches}, expected {expect}")
    if not pointclouds_equal(runs[0], runs[-1]):
        raise AssertionError("dense: two runs of the same frames differ")
    LAUNCHES["dense_gt_easy"] = launches
    count = check_map(pc_dense, frames.poses, REF_COUNT_GT, "dense")
    n_gt, n_lock = int(pc_gt.num_points[0]), int(pc_lock.num_points[0])
    if abs(count - n_gt) > DENSE_GT_REL * n_gt:
        raise AssertionError(f"dense: {count} points against the gt pipeline's {n_gt}")
    m = min(count, n_gt)
    rows_gap = (pc_dense.points[0, :m] - pc_gt.points[0, :m]).abs().amax(-1)
    matched = float((rows_gap <= DENSE_ATOL).double().mean())
    dense_secs = float(np.mean(secs))
    w = lock.worst
    log(f"dense lockstep {H}x{W}x{L_}, gt poses: at every frame the dense steps on the fast "
        f"path's projection equal update_map_fusion(sort_full) from the same map: counts equal, "
        f"max |d| points {w['points']:.3e}, normals {w['normals']:.3e}, colors "
        f"{w['colors']:.3e}, ccounts {w['features']:.3e}, mass {w['mass_rel']:.3e} relative; "
        f"find_active_map_points and _project_map_points part on {sum(lock.flips)} rows in all "
        f"(at most {max(lock.flips)} a frame); final map {n_lock} points")
    log(f"dense (find_correspondences + fuse_with_map) {H}x{W}x{L_}, gt poses: map {count} "
        f"points (reference {REF_COUNT_GT}, {100 * (count - REF_COUNT_GT) / REF_COUNT_GT:+.4f}%), "
        f"0 dropped, two runs bit-equal; against the gt pipeline's map ({n_gt}): count gap "
        f"{count - n_gt:+d}, {100 * matched:.4f}% of the first {m} rows within {DENSE_ATOL}; "
        f"against the lockstep run's: {count - n_lock:+d}; {dense_secs:.4f} s/run "
        f"({L_ / dense_secs:.4f} frames/s, mean of {TIMED_RUNS}) beside the gt fast path's "
        f"{secs_gt:.4f} s/run ({dense_secs / secs_gt:.2f}x); launches a run {launches}")

    # (b) the scatter kernel on the last frame's append
    if [tuple(v.shape[2:]) for _, _, v, _ in tail.calls] != [(3,), (3,), (3,), (1,)]:
        raise AssertionError(f"dense: the last append's calls {[tuple(v.shape) for _, _, v, _ in tail.calls]}")
    for i, (buf, dest, values, _) in enumerate(tail.calls):
        args = (buf.contiguous(), dest.contiguous(), values.contiguous(), None)
        if not torch.equal(int_view(scatter_kernel(*args)), int_view(scatter_plain(*args))):
            raise AssertionError(f"dense: the scatter kernel differs from its plain version on "
                                 f"the last append's call {i}")
    kept = int(((tail.calls[0][1] >= 0) & (tail.calls[0][1] < pc_dense.capacity)).sum())
    log(f"dense: the scatter kernel bit-equal to its plain version on the last frame's four "
        f"append calls (dest {tuple(tail.calls[0][1].shape)} {tail.calls[0][1].dtype}, "
        f"{kept} rows appended into {pc_dense.capacity})")
    rows = []
    for i, width in ((0, 3), (3, 1)):
        buf, dest, values, _ = tail.calls[i]
        rows.append(time_scatter(f"dense_append_{width}f_into_{buf.shape[1]}", buf.contiguous(),
                                 dest.contiguous(), values.contiguous(), None))

    # (c) the structure API
    structure_api_phase(pc_gt, frames)
    if not tf32_disabled():
        raise AssertionError("structures: TF32 enabled after the phase")
    return rows


# --------------------------------------------------------------------------- #
# The parallel slice: MapShardedPointFusion and DataParallelSLAM under NCCL
# at world size 1 (sharded_phase), and the frame loader API (loader_phase).
# --------------------------------------------------------------------------- #

SHARDED_CAP = 2 * H * W  # 614,400 rows: nothing overflows on the easy clip
SHARDED_ROWS = {  # (the golden's and the card's rows, on synthetic_sequence(1, L, H, W))
    "gt": dict(odom="gt"),
    "knn": dict(odom="gradicp", dsratio=DSRATIO, numiters=NUMITERS),
    "projective": dict(odom="gradicp", odom_assoc="projective", dsratio=2, numiters=6),
}
SHARDED_GOLDEN = Path(__file__).resolve().parent / "tests/port/data/sharded_jax_cpu.npz"
SHARDED_GOLDEN_K = 4  # the golden's virtual CPU mesh
SHARDED_POINTS_ATOL = {"gt": 1e-5, "knn": 1e-4, "projective": 1e-4}  # sorted rows
SHARDED_POSE_ATOL = {"gt": 0.0, "knn": 1e-5, "projective": 1e-5}
SHARDED_MASS_RTOL = 1e-5  # confidence mass against PointFusion on the card
# A tracked row's ICP window is selected by the fusion projection
# (_project_map_points, as the JAX package's sharded path does), PointFusion's
# by find_active_map_points; the two round a few rows onto neighbouring pixels
# (ROADMAP queue 3, "Not faults"), the poses part by ~1e-6 and a few merges
# near the distance gate flip: the counts are held within 0.2%, and the
# sorted rows only where the counts are equal.
SHARDED_TRACKED_COUNT_REL = 0.002
SHARDED_GOLDEN_COUNT_REL = 0.002
SHARDED_GOLDEN_MASS_REL = 1e-3
# Tracked rows against the golden: the unaligned translation RMSE within 2x
# and the poses within 1e-4. Not the Umeyama-aligned ATE: on this clip's 30
# frames of near-straight translation the alignment is ill-conditioned; the
# port's and JAX's single-device projective poses part by at most 3.6e-7
# on the CPU, yet their aligned ATEs read 5.93e-5 and 9.81e-6 m (the
# golden's unaligned RMSE is 5.94e-5 m).
SHARDED_GOLDEN_ATE_FACTOR = 2.0
SHARDED_GOLDEN_POSE_ATOL = 1e-4
SHARDED_STEADY_CALLS = 3  # captured calls after the first; s/run is their median
SHARDED_2D = dict(shape=(2, 8, 240, 320), odom="gt")  # a (dp=1, map=1) mesh with batch_axis
SHARDED_DP_SHAPE = (2, 8, 480, 640)  # DataParallelSLAM(PointFusion(odom='gt'))
LOADER_SIZES = ((480, 640), (240, 320))  # the frame loader against the C++ arithmetic


class LastScatterCalls:
    """While active, keeps the last scatter call of each kind (``'into'``,
    a copy of a buffer, or ``'new'``, a new table) and row shape made
    through the dispatchers (the kernel still runs)."""

    def __init__(self):
        self.calls = {}

    def __enter__(self):
        self._real = (pointclouds_module._scatter_rows, pointclouds_module._scatter_rows_into)

        def new(size, dest, values, fill):
            self.calls[("new", tuple(values.shape[2:]), values.dtype)] = (size, dest, values, fill)
            return self._real[0](size, dest, values, fill)

        def into(buf, dest, values):
            self.calls[("into", tuple(values.shape[2:]), values.dtype)] = (buf, dest, values, None)
            return self._real[1](buf, dest, values)

        pointclouds_module._scatter_rows, pointclouds_module._scatter_rows_into = new, into
        return self

    def __exit__(self, *exc):
        pointclouds_module._scatter_rows, pointclouds_module._scatter_rows_into = self._real


def sharded_launches(kw: dict, L_: int) -> dict:
    """Both kernels' launches of one MapShardedPointFusion run, derived from
    the code: a fused frame scatters its winner table and its append map
    (2 a frame); a tracked frame compacts its window once a level; a 1-NN
    level searches twice an iteration (the fresh lookahead), a projective
    level never."""
    levels = kw.get("pyramid") or [(kw.get("dsratio", 4), kw.get("numiters", 20))]
    tracked = kw.get("odom", "gt") != "gt"
    knn_iters = sum(n for _, n in levels) if kw.get("odom_assoc", "knn") == "knn" else 0
    return {"knn": 2 * knn_iters * (L_ - 1) if tracked else 0,
            "scatter": 2 * L_ + (len(levels) * (L_ - 1) if tracked else 0)}


def unaligned_rmse_m(poses: np.ndarray, gt: np.ndarray) -> float:
    """Translation RMSE (m) of ``(L, 4, 4)`` poses against ground truth,
    without alignment."""
    err = poses[:, :3, 3].astype(np.float64) - gt[:, :3, 3].astype(np.float64)
    return float(np.sqrt(np.mean(np.sum(err ** 2, axis=-1))))


def sorted_rows(pc, b: int = 0) -> torch.Tensor:
    """The live points of cloud ``b`` sorted by (x, y, z), on its device."""
    pts = pc.points[b, :int(pc.num_points[b])]
    for col in (2, 1, 0):
        pts = pts[torch.sort(pts[:, col], stable=True).indices]
    return pts


def live_ccount_mass(pc) -> float:
    n = int(pc.num_points[0])
    return float(pc.features[0, :n, 0].double().sum())


def sharded_digest(smap, poses) -> str:
    """SHA-256 of a map-sharded run's shard, counters and poses."""
    return sha256_of(smap.points, smap.normals, smap.colors, smap.features, smap.num_points,
                     smap.num_dropped, poses)


def collective_tallies() -> dict:
    """The collectives' bytes and calls by tag since their last reset."""
    from gradslam_torch.parallel import collectives

    return {"bytes": dict(collectives.BYTES), "calls": dict(collectives.CALLS)}


def sharded_captured(frames, mesh, name: str, kw: dict, want: str, tallies: dict) -> dict:
    """Row ``name`` with ``use_jit`` on (its frames after the first replayed
    from one CUDA graph with the NCCL collectives inside it) beside its
    eager run (digest ``want``, launches ``LAUNCHES['sharded_<name>']``,
    collective ``tallies``): a first call (the warm-up, under the sync
    debug mode "error", and the capture) and ``SHARDED_STEADY_CALLS``
    steady ones (every frame replayed), each with both kernels' counts and
    the collectives' tallies from 0: SHA-256-equal to eager, the launches that the counters add up
    (``CAPTURED_LAUNCHES``) and the bytes and calls of each tag equal to
    eager's, ``last_call_captured`` True, one graph, the first call's
    result as the caller held it unchanged by the second; then a profiled
    replayed call, whose device trace shows no more ``knn1_search`` and
    ``scatter_rows<`` events than :func:`sharded_launches` derives, and a
    profiled eager call (a pipeline with ``use_jit=False``) for its busy
    share. Returns the measurements."""
    from gradslam_torch.parallel import MapShardedPointFusion, collectives

    L_ = frames.shape[1]
    jit = MapShardedPointFusion(map_capacity=SHARDED_CAP, mesh=mesh, **kw)
    secs, digests = {"first": [], "steady": []}, set()
    for i in range(1 + SHARDED_STEADY_CALLS):
        call = "steady" if i else "first"
        if i == 1:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        collectives.reset_counts()
        (smap, poses), launches, t = counted(lambda: jit(frames))
        secs[call].append(t)
        CAPTURED_LAUNCHES[f"sharded_{name}_{call}"] = launches
        if not jit.last_call_captured:
            raise AssertionError(f"sharded {name}: not captured ({jit.last_eager_reason})")
        if launches != LAUNCHES[f"sharded_{name}"] or collective_tallies() != tallies:
            raise AssertionError(f"sharded {name} captured {call} call: launches {launches}, "
                                 f"collectives {collective_tallies()}; eager "
                                 f"{LAUNCHES[f'sharded_{name}']}, {tallies}")
        digests.add(sharded_digest(smap, poses))
        if i == 0:
            held = (smap, poses)
    peak = torch.cuda.max_memory_allocated()
    if digests != {want} or sharded_digest(*held) != want:
        raise AssertionError(f"sharded {name}: captured {digests}, held first call "
                             f"{sharded_digest(*held)}, eager {want}")
    graphs = len(jit.frame_graphs)
    if graphs != 1:
        raise AssertionError(f"sharded {name}: {graphs} graphs, one expected")
    del held, smap, poses
    trace = device_profile(lambda: jit(frames))
    expect = sharded_launches(kw, L_)
    if any(trace["kernels"][k] > expect[k] for k in expect):
        raise AssertionError(f"sharded {name}: the replayed call's device trace shows "
                             f"{trace['kernels']}, more than the {expect} derived")
    capture_s = jit.frame_graphs.capture_s
    del jit
    eager = MapShardedPointFusion(map_capacity=SHARDED_CAP, mesh=mesh, use_jit=False, **kw)
    eager_trace = device_profile(lambda: eager(frames))
    return dict(first_s=secs["first"][0], steady_s=float(np.median(secs["steady"])),
                steady_range=(min(secs["steady"]), max(secs["steady"])), peak_b=peak, graphs=graphs,
                capture_s=capture_s, busy_s=trace["busy_s"], events=trace["events"],
                kernels=trace["kernels"], expect=expect, eager_busy_s=eager_trace["busy_s"],
                eager_events=eager_trace["events"])


def sharded_phase(frames, P) -> list:
    """The map-sharded slice (``gradslam_torch/parallel``) under NCCL at
    world size 1: ``torch.distributed.init_process_group('nccl')`` with a
    ``file://`` store (no network), destroyed at the end of the phase.

    (a) Each ``SHARDED_ROWS`` row of ``MapShardedPointFusion`` with
        ``use_jit=False`` on the easy 640x480x30 clip at ``SHARDED_CAP``
        rows: a warm-up, then one counted run (both kernels' launches from
        0, against ``sharded_launches``),
        beside ``PointFusion`` at the same settings on the card (its own
        warm-up and counted run): equal map counts (tracked rows: within
        ``SHARDED_TRACKED_COUNT_REL``), the rows sorted by (x, y, z) within
        ``SHARDED_POINTS_ATOL`` where the counts are equal, confidence mass
        within ``SHARDED_MASS_RTOL`` relative, poses within
        ``SHARDED_POSE_ATOL``, the shard counters summing to the count and
        0 dropped; against the JAX package's 4-device CPU golden
        (``SHARDED_GOLDEN``): count within 0.2%, mass within 1e-3 relative,
        tracked poses within ``SHARDED_GOLDEN_POSE_ATOL`` and unaligned RMSE
        within 2x (aligned ATE reported); the
        winner-table traffic exactly ``3 * K * B * H*W * 4`` bytes a fused
        frame; s/run and peak memory beside the single-device run's. Then
        the row captured, beside the eager run (:func:`sharded_captured`):
        s/run first and steady (the median of ``SHARDED_STEADY_CALLS``),
        busy share, device events, graphs, capture s and peak memory beside
        ``PointFusion``'s captured run.
    (b) A 2-D ``(dp=1, map=1)`` mesh with ``batch_axis`` at ``SHARDED_2D``
        against ``PointFusion``.
    (c) ``DataParallelSLAM(PointFusion(odom='gt'))`` at ``SHARDED_DP_SHAPE``
        SHA-256-equal to ``PointFusion`` on the same batch.
    (d) The scatter kernel bit-equal to its plain version on the last
        warm-up's last winner table, append map and window compaction, each
        timed.

    Every row runs on the card (asserted); nothing is caught. Returns the
    scatter kernel's new timed shapes."""
    import tempfile

    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from gradslam_torch.parallel import (
        DataParallelSLAM,
        MapShardedPointFusion,
        collectives,
        make_mesh,
    )

    golden = np.load(SHARDED_GOLDEN)
    B_, L_, H_, W_ = frames.shape
    store = tempfile.mkdtemp(prefix="sharded_store_")
    dist.init_process_group("nccl", init_method=f"file://{store}/store", rank=0, world_size=1)
    try:
        mesh = make_mesh(axis_name="map")
        K = mesh.size()
        spy = LastScatterCalls()
        for name, kw in SHARDED_ROWS.items():
            sharded = MapShardedPointFusion(map_capacity=SHARDED_CAP, mesh=mesh, use_jit=False,
                                            **kw)
            single = PointFusion(map_capacity=SHARDED_CAP, **kw)
            with spy:
                sharded(frames)
            collectives.reset_counts()
            torch.cuda.reset_peak_memory_stats()
            (smap, poses), launches, secs = counted(lambda: sharded(frames))
            peak = torch.cuda.max_memory_allocated()
            tallies = collective_tallies()
            fusion = (collectives.BYTES["fusion"], collectives.CALLS["fusion"])
            if not (smap.points.is_cuda and poses.is_cuda):
                raise AssertionError(f"sharded {name}: the row ran on {smap.points.device}")
            expect = sharded_launches(kw, L_)
            if launches != expect:
                raise AssertionError(f"sharded {name}: launches {launches}, expected {expect}")
            LAUNCHES[f"sharded_{name}"] = launches
            if fusion != (L_ * 3 * K * B_ * H_ * W_ * 4, L_):
                raise AssertionError(f"sharded {name}: winner-table traffic {fusion}")
            single(frames)
            torch.cuda.reset_peak_memory_stats()
            (pc_s, poses_s), launches_s, secs_s = counted(lambda: single(frames))
            peak_s = torch.cuda.max_memory_allocated()
            pc = smap.to_pointclouds()
            count, count_s = int(pc.num_points[0]), int(pc_s.num_points[0])
            mass, mass_s = live_ccount_mass(pc), live_ccount_mass(pc_s)
            pose_gap = float((poses - poses_s).abs().max())
            tracked = kw["odom"] != "gt"
            if (int(smap.num_points.sum()) != count
                    or abs(count - count_s) > (SHARDED_TRACKED_COUNT_REL * count_s if tracked
                                               else 0)):
                raise AssertionError(f"sharded {name}: {count} points ({smap.num_points.tolist()}"
                                     f" by shard) against PointFusion's {count_s}")
            if int(smap.num_dropped.sum()) or int(pc_s.num_dropped.sum()):
                raise AssertionError(f"sharded {name}: dropped rows")
            rows_gap = (float((sorted_rows(pc) - sorted_rows(pc_s)).abs().max())
                        if count == count_s else float("nan"))
            if ((count == count_s and not rows_gap <= SHARDED_POINTS_ATOL[name])
                    or pose_gap > SHARDED_POSE_ATOL[name]
                    or abs(mass - mass_s) > SHARDED_MASS_RTOL * mass_s):
                raise AssertionError(f"sharded {name}: rows {rows_gap}, poses {pose_gap}, mass "
                                     f"{mass} against PointFusion's {mass_s}")
            g_count, g_mass = int(golden[f"{name}_num_points"]), float(golden[f"{name}_mass"])
            host_poses, g_poses = poses[0].cpu().numpy(), golden[f"{name}_poses"]
            ate, g_ate = ate_m(host_poses, P[0]), float(golden[f"{name}_ate_m"])
            rmse, g_rmse = unaligned_rmse_m(host_poses, P[0]), unaligned_rmse_m(g_poses, P[0])
            golden_gap = float(np.abs(host_poses - g_poses).max())
            if (abs(count - g_count) > SHARDED_GOLDEN_COUNT_REL * g_count
                    or abs(mass - g_mass) > SHARDED_GOLDEN_MASS_REL * g_mass
                    or (tracked and (rmse > SHARDED_GOLDEN_ATE_FACTOR * g_rmse
                                     or golden_gap > SHARDED_GOLDEN_POSE_ATOL))):
                raise AssertionError(f"sharded {name}: map {count}, mass {mass}, unaligned RMSE "
                                     f"{rmse}, poses {golden_gap} from the golden's ({g_count}, "
                                     f"{g_mass}, {g_rmse})")
            log(f"sharded {name} {H_}x{W_}x{L_} (K={K}, NCCL, {SHARDED_CAP} rows): "
                f"{secs:.4f} s/run beside PointFusion's {secs_s:.4f} s/run ({secs / secs_s:.3f}x), "
                f"peak memory {peak} B beside {peak_s} B; map {count} points (PointFusion "
                f"{count_s}, {count - count_s:+d}; JAX 4-device golden {g_count}, {100 * (count - g_count) / g_count:+.4f}%"
                f", shards {golden[f'{name}_shard_counts'].tolist()}), 0 dropped; sorted rows "
                f"within {rows_gap:.3e}, poses within {pose_gap:.3e}, mass {mass:.6f} (PointFusion "
                f"{mass_s:.6f}, golden {g_mass:.6f}); poses within {golden_gap:.3e} of the golden's, "
                f"unaligned RMSE {rmse:.4e} m (golden {g_rmse:.4e}), aligned ATE {ate:.4e} m "
                f"(golden {g_ate:.4e}); "
                f"winner-table traffic {fusion[0]} B in {fusion[1]} all-gathers; launches {launches}"
                f" (PointFusion {launches_s})")
            want = sharded_digest(smap, poses)
            del smap, poses, pc, pc_s, poses_s, sharded, single
            r = sharded_captured(frames, mesh, name, kw, want, tallies)
            log(f"sharded {name} captured (use_jit, the NCCL collectives inside the graph): "
                f"SHA-256-equal to eager ({want[:16]}), launches {launches} and collectives "
                f"{tallies} in each call, the held first result unchanged; s/run eager "
                f"{secs:.4f}, captured first {r['first_s']:.4f}, steady {r['steady_s']:.4f} "
                f"(median of {SHARDED_STEADY_CALLS}, {r['steady_range'][0]:.4f}-"
                f"{r['steady_range'][1]:.4f}) "
                f"({secs / r['steady_s']:.2f}x faster; {r['steady_s'] / secs_s:.3f}x "
                f"PointFusion's captured {secs_s:.4f}); device busy {r['busy_s']:.4f} s "
                f"({100 * r['busy_s'] / r['steady_s']:.1f}% of the steady call; eager "
                f"{r['eager_busy_s']:.4f} s, {100 * r['eager_busy_s'] / secs:.1f}%), "
                f"{r['events']} device events (eager {r['eager_events']}), its trace shows "
                f"{r['kernels']} (derived {r['expect']}); {r['graphs']} graph captured in "
                f"{r['capture_s']:.4f} s; peak memory {r['peak_b']} B (eager {peak} B, "
                f"PointFusion captured {peak_s} B, {(r['peak_b'] - peak_s) / 2**30:+.3f} GiB)")

        # (b) a 2-D (dp=1, map=1) mesh with batch_axis
        shape2 = SHARDED_2D["shape"]
        f2 = rgbdimages_from_numpy(*synthetic_sequence(*shape2, seed=0), device="cuda")
        mesh2 = DeviceMesh("cuda", torch.zeros((1, 1), dtype=torch.int64),
                           mesh_dim_names=("dp", "map"))
        cap2 = 2 * shape2[2] * shape2[3]
        smap2, poses2 = MapShardedPointFusion(map_capacity=cap2, mesh=mesh2, batch_axis="dp",
                                              odom=SHARDED_2D["odom"])(f2)
        pc2_s, poses2_s = PointFusion(map_capacity=cap2, odom=SHARDED_2D["odom"])(f2)
        pc2 = smap2.to_pointclouds()
        if not torch.equal(pc2.num_points, pc2_s.num_points) or not torch.equal(poses2, poses2_s):
            raise AssertionError(f"sharded 2-D mesh: counts {pc2.num_points.tolist()} against "
                                 f"{pc2_s.num_points.tolist()}")
        gap2 = max(float((sorted_rows(pc2, b) - sorted_rows(pc2_s, b)).abs().max())
                   for b in range(shape2[0]))
        if gap2 > SHARDED_POINTS_ATOL["gt"]:
            raise AssertionError(f"sharded 2-D mesh: rows {gap2}")
        log(f"sharded 2-D mesh (dp=1, map=1) with batch_axis, B={shape2[0]} "
            f"{shape2[2]}x{shape2[3]}x{shape2[1]} gt: maps {pc2.num_points.tolist()} equal to "
            f"PointFusion's, sorted rows within {gap2:.3e}, poses equal")

        # (c) DataParallelSLAM against PointFusion on the same batch
        f3 = rgbdimages_from_numpy(*synthetic_sequence(*SHARDED_DP_SHAPE, seed=0), device="cuda")
        dp = DataParallelSLAM(PointFusion(odom="gt"), make_mesh())
        (pc3, poses3), _, secs3 = counted(lambda: dp(f3))
        (pc3_s, poses3_s), _, secs3_s = counted(lambda: PointFusion(odom="gt")(f3))
        d3, d3_s = (sha256_of(p.points, p.normals, p.colors, p.features, p.num_points, q)
                    for p, q in ((pc3, poses3), (pc3_s, poses3_s)))
        if d3 != d3_s:
            raise AssertionError("DataParallelSLAM differs from PointFusion on the same batch")
        log(f"DataParallelSLAM(PointFusion(odom='gt')) B={SHARDED_DP_SHAPE[0]} "
            f"{SHARDED_DP_SHAPE[3]}x{SHARDED_DP_SHAPE[2]}x{SHARDED_DP_SHAPE[1]}: SHA-256-equal to "
            f"PointFusion ({d3[:16]}), maps {pc3.num_points.tolist()}; {secs3:.4f} s beside "
            f"{secs3_s:.4f} s")
    finally:
        dist.destroy_process_group()

    # (d) the scatter kernel on the sharded path's own calls
    rows = []
    wanted = {("into", (3,), torch.float32): "sharded_winner_table",
              ("new", (), torch.int64): "sharded_append_map",
              ("new", (6,), torch.float32): "sharded_window"}
    if set(wanted) - set(spy.calls):
        raise AssertionError(f"sharded: scatter calls seen {sorted(spy.calls)}")
    for key, label in wanted.items():
        table, dest, values, fill = spy.calls[key]
        table = table.contiguous() if not isinstance(table, int) else table
        args = (table, dest.contiguous(), values.contiguous(), fill)
        if not torch.equal(int_view(scatter_kernel(*args)), int_view(scatter_plain(*args))):
            raise AssertionError(f"sharded: the scatter kernel differs from its plain version on "
                                 f"{label}")
        size = table if isinstance(table, int) else table.shape[1]
        rows.append(time_scatter(f"{label}_{dest.shape[1]}_into_{size}", *args))
    log("sharded: the scatter kernel bit-equal to its plain version on the winner table, the "
        "append map and the window compaction")
    return rows


def libframeio_color(image: np.ndarray, H_: int, W_: int, normalize: bool) -> np.ndarray:
    """``native/frameio/frameio.cpp:134-166`` transcribed row by row into
    numpy float32 (the card's host has no png.h to build the library):
    ``sy = (float)h / H``; ``fy = (y + 0.5f) * sy - 0.5f``, ``y0 = (int)fy``,
    ``fy < 0`` clamps both to 0; ``y1`` clamped; the four-term sum in the
    C++ order; ``* (1.0f / 255)`` when normalizing. 8-bit samples only."""
    f32 = np.float32
    h, w = image.shape[:2]
    img = image if image.ndim == 3 else image[..., None]
    sy, sx = f32(h) / f32(H_), f32(w) / f32(W_)
    fx = (np.arange(W_).astype(f32) + f32(0.5)) * sx - f32(0.5)
    x0 = np.where(fx < 0, 0, np.trunc(fx)).astype(np.int64)
    fx = np.where(fx < 0, f32(0), fx)
    x1 = np.minimum(x0 + 1, w - 1)
    wx = (fx - x0.astype(f32))[:, None]
    ch = np.arange(3) if img.shape[2] >= 3 else np.zeros(3, dtype=np.int64)
    out = np.empty((H_, W_, 3), dtype=f32)
    for y in range(H_):
        fy = (f32(y) + f32(0.5)) * sy - f32(0.5)
        y0 = 0 if fy < 0 else int(fy)
        fy = f32(0) if fy < 0 else fy
        y1 = min(y0 + 1, h - 1)
        wy = f32(fy - f32(y0))
        v00, v01 = img[y0][x0][:, ch].astype(f32), img[y0][x1][:, ch].astype(f32)
        v10, v11 = img[y1][x0][:, ch].astype(f32), img[y1][x1][:, ch].astype(f32)
        one = f32(1)
        out[y] = (v00 * (one - wy) * (one - wx) + v01 * (one - wy) * wx
                  + v10 * wy * (one - wx) + v11 * wy * wx)
    return out * (f32(1) / f32(255)) if normalize else out


def libframeio_depth(image: np.ndarray, H_: int, W_: int, scale: float) -> np.ndarray:
    """``native/frameio/frameio.cpp:168-190`` in numpy float32: the sample
    at ``(int)(y * sy)``, clamped, times ``1.0f / scale``."""
    f32 = np.float32
    h, w = image.shape
    ys = np.minimum((np.arange(H_).astype(f32) * (f32(h) / f32(H_))).astype(np.int64), h - 1)
    xs = np.minimum((np.arange(W_).astype(f32) * (f32(w) / f32(W_))).astype(np.int64), w - 1)
    return image[ys][:, xs].astype(f32) * (f32(1) / f32(scale))


def loader_phase() -> None:
    """The frame loader API (``gradslam_torch/datasets/frameio.py``) on the
    640x480x30 TUM tree of the dataset phase (written again under
    ``DS_DIR``, removed after): ``decode_color``/``decode_depth`` at
    ``LOADER_SIZES`` bit-equal to the numpy transcription of the C++
    (:func:`libframeio_color`, :func:`libframeio_depth`) on the samples the
    plain codec decodes, normalized and not; ``FrameLoader``'s 30 frames,
    fetched out of order, bit-equal to the one-shot decoders; the TUM
    loader's ``'native'`` sample bit-equal to them; and the host's ms a
    frame (colour + depth decoded and resized): serially, and through
    ``FrameLoader`` at ``LOADER_THREADS`` threads, two loaders of each in
    turn. Fails if a loader leaves a process behind."""
    root = Path(DS_DIR)
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir()
    try:
        clip = dataset_clip(TUM_INTRINSICS, (DS_L, 480, 640))
        write_tum_tree(root, clip)
        seq = root / TUM_SEQUENCE
        cpaths = sorted(str(p) for p in (seq / "rgb").iterdir())
        dpaths = sorted(str(p) for p in (seq / "depth").iterdir())
        for H_, W_ in LOADER_SIZES:
            for i in (0, 17):
                with open(cpaths[i], "rb") as f:
                    img = frameio.decode_png_plain(f.read())
                with open(dpaths[i], "rb") as f:
                    dep = frameio.decode_png_plain(f.read())
                for normalize in (False, True):
                    got = frameio.decode_color(cpaths[i], H_, W_, normalize)
                    if not np.array_equal(got, libframeio_color(img, H_, W_, normalize)):
                        raise AssertionError(f"loader: decode_color differs at {H_}x{W_}")
                if not np.array_equal(frameio.decode_depth(dpaths[i], H_, W_, DEPTH_UNITS_PER_M),
                                      libframeio_depth(dep, H_, W_, DEPTH_UNITS_PER_M)):
                    raise AssertionError(f"loader: decode_depth differs at {H_}x{W_}")
        H_, W_ = LOADER_SIZES[-1]
        before = set(_descendants(os.getpid()))
        t0 = time.perf_counter()
        serial = [(frameio.decode_color(c, H_, W_), frameio.decode_depth(d, H_, W_, 5000.0))
                  for c, d in zip(cpaths, dpaths)]
        t_serial = time.perf_counter() - t0
        t_pool = {n: [] for n in LOADER_THREADS}
        for _ in range(2):
            for threads in LOADER_THREADS:
                t0 = time.perf_counter()
                loader = frameio.FrameLoader(H_, W_, 5000.0, num_threads=threads)
                loader.submit_sequence(cpaths, dpaths)
                pooled = {i: loader.fetch(i) for i in list(range(DS_L))[::-1]}
                loader.close()
                t_pool[threads].append(time.perf_counter() - t0)
                for i in range(DS_L):
                    if not (np.array_equal(serial[i][0], pooled[i][0])
                            and np.array_equal(serial[i][1], pooled[i][1])):
                        raise AssertionError(f"loader: frame {i} differs between the loaders")
        sample = TUM(str(root), sequences=(TUM_SEQUENCE,), seqlen=DS_L, height=H_, width=W_,
                     loader="native", return_pose=False, return_transform=False,
                     return_names=False, return_timestamps=False)[0]
        if not (np.array_equal(sample[0].numpy(), np.stack([c for c, _ in serial]))
                and np.array_equal(sample[1].numpy()[..., 0], np.stack([d for _, d in serial]))):
            raise AssertionError("loader: TUM(loader='native') differs from the decoders")
        left = new_children(before)
        if left:
            raise AssertionError(f"loader: FrameLoader left processes {sorted(left)}")
        per_frame = {n: " and ".join(f"{1e3 * t / DS_L:.3f}" for t in ts)
                     for n, ts in t_pool.items()}
        log(f"loader {DS_L} frames 480x640 read at {H_}x{W_}: decode_color/decode_depth bit-equal "
            f"to the C++ arithmetic's transcription at {LOADER_SIZES}; host ms a frame (colour + "
            f"depth, decoded and resized): serial {1e3 * t_serial / DS_L:.3f} (earlier "
            f"{EARLIER_HOST['serial']}), FrameLoader " + "; ".join(
                f"{n} threads {v}" for n, v in per_frame.items())
            + f" on two loaders each, in turn (earlier {EARLIER_HOST['pool']}); all bit-equal, "
            "TUM(loader='native') too; no process started")
    finally:
        shutil.rmtree(root, ignore_errors=True)


# use_jit (PR 13): each path run with use_jit=False (eager) and use_jit=True
# (each frame's body replayed from its CUDA graph) on the same frames:
# path -> (pipeline, constructor arguments, clip, launches a run). The step
# loop is the online tracked row at ONLINE_CAP (constant velocity).
GRAPH_PATHS = {
    "tracked": ("PointFusion", dict(odom="gradicp", dsratio=DSRATIO, numiters=NUMITERS,
                                    map_capacity=SCHEDULE), "easy",
                {"knn": KNN_LAUNCHES_PER_RUN, "scatter": SCATTER_LAUNCHES["tracked_easy"]}),
    "gt": ("PointFusion", dict(odom="gt", map_capacity=SCHEDULE), "easy",
           {"knn": 0, "scatter": SCATTER_LAUNCHES["gt_easy"]}),
    "production": ("PointFusion", PRODUCTION, "hard",
                   {"knn": PROD_LAUNCHES_PER_RUN, "scatter": SCATTER_LAUNCHES["production_hard"]}),
    "icpslam_flat": ("ICPSLAM", dict(ICPSLAM_CONFIGS["flat"], map_capacity=ICP_SCHEDULE), "icp",
                     {"knn": ICP_KNN_LAUNCHES["flat"], "scatter": SCATTER_LAUNCHES["icpslam_flat"]}),
    "icpslam_window_pyramid": (
        "ICPSLAM", dict(ICPSLAM_CONFIGS["window_pyramid"], map_capacity=ICP_SCHEDULE), "icp",
        {"knn": ICP_KNN_LAUNCHES["window_pyramid"],
         "scatter": SCATTER_LAUNCHES["icpslam_window_pyramid"]}),
    "step_tracked": ("PointFusion", dict(ONLINE_ROWS["tracked"], map_capacity=ONLINE_CAP), "easy",
                     {"knn": KNN_LAUNCHES_PER_RUN, "scatter": SCATTER_LAUNCHES["tracked_easy"]}),
}
GRAPH_ROWS = {}  # path -> {"eager" | "jit": its measurements}


def knn_graph_check(src, tgt, mask) -> None:
    """One 1-NN call (its three kernels from one C call) captured in a CUDA
    graph and replayed: the replay rewrites both outputs (set to all-ones
    bits first) with the eager call's bits, also after 64 MB of other
    allocations churned the caching allocator (the scratch the call took
    inside the capture lives in the graph's pool, which nothing else takes),
    and a replay after new points are copied into the captured inputs gives
    the eager call's bits on the new points."""
    src, tgt, mask = src.clone(), tgt.clone(), mask.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the default stream, as for capture
        knn_cuda.nn_points_cuda(src, tgt, mask)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        d, i = knn_cuda.nn_points_cuda(src, tgt, mask)
    churn = torch.full((16 * 2**20,), float("nan"), device=src.device)
    g = torch.Generator(device="cpu").manual_seed(1)
    for step in ("capture", "new points"):
        if step == "new points":
            src.copy_(src.flip(1) + 0.01 * torch.randn(src.shape, generator=g).to(src.device))
            tgt.copy_(tgt + 0.01 * torch.randn(tgt.shape, generator=g).to(tgt.device))
        d.view(torch.int32).fill_(-1)
        i.fill_(-1)
        graph.replay()
        torch.cuda.synchronize()
        de, ie = knn_cuda.nn_points_cuda(src, tgt, mask)
        if not (torch.equal(d.view(torch.int32), de.view(torch.int32)) and torch.equal(i, ie)):
            raise AssertionError(f"knn graph: replay ({step}) differs from the eager call")
    del churn
    log(f"knn graph {tuple(src.shape)} against {tuple(tgt.shape)}: one captured call (three "
        "kernels), replayed twice (the second on new points), gives the eager call's bits")


def graph_phase(clips: dict) -> None:
    """use_jit on the card: each GRAPH_PATHS path run with use_jit=False and
    then use_jit=True on the same frames, a fresh pipeline each: the first
    call (for use_jit=True the warm-up frames, run under the sync debug
    mode "error", and the captures) and a steady-state call, each with both
    kernels' counts set to 0 just before it and held against the path's
    launches; then a device-only profile. Holds the map and poses SHA-256-
    equal between the modes and between calls, ``last_call_captured`` equal
    to ``use_jit``, and the first call's result (held by the caller)
    unchanged after the later calls replayed its graphs. Then a gradient
    row and an armed row run captured, and one 1-NN call captured and
    replayed against its eager call."""
    for name, (cls, kw, clip, expect) in GRAPH_PATHS.items():
        t_path = time.perf_counter()
        frames = clips[clip]
        rows = {}
        for mode, use_jit in (("eager", False), ("jit", True)):
            slam = globals()[cls](use_jit=use_jit, **kw)
            if name == "step_tracked":
                def run(slam=slam):
                    return step_loop(slam, frames, cv=True)
            else:
                def run(slam=slam):
                    return slam(frames)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()  # held by earlier phases' pipelines
            secs, digests = [], []
            for call in ("first", "steady"):
                knn_cuda.launches = 0
                scatter_cuda.launches = 0
                t0 = time.perf_counter()
                pc, poses = run()
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
                got = {"knn": knn_cuda.launches, "scatter": scatter_cuda.launches}
                LAUNCHES[f"graph_{name}_{mode}"] = got
                if got != expect:
                    raise AssertionError(f"graph {name} {mode} ({call} call): launches {got}, "
                                         f"expected {expect}")
                if slam.last_call_captured != use_jit:
                    raise AssertionError(f"graph {name} {mode}: last_call_captured "
                                         f"{slam.last_call_captured} ({slam.last_eager_reason})")
                digests.append(map_digest(pc, poses))
                if call == "first":
                    held = (pc, poses)
            peak = torch.cuda.max_memory_allocated() - base
            busy, events = device_events(run)
            if map_digest(*held) != digests[0]:
                raise AssertionError(f"graph {name} {mode}: the first call's result changed "
                                     "when later calls replayed its graphs")
            n_graphs = len(getattr(slam, "frame_graphs", ()))
            rows[mode] = dict(first_s=secs[0], steady_s=secs[1], busy_s=busy, events=events,
                              peak_b=peak, digests=digests, graphs=n_graphs,
                              capture_s=slam.frame_graphs.capture_s, count=int(pc.num_points[0]))
            del slam, run, pc, poses, held
        if len({*rows["eager"]["digests"], *rows["jit"]["digests"]}) != 1:
            raise AssertionError(f"graph {name}: map or poses differ between the modes or calls: "
                                 f"{ {m: r['digests'] for m, r in rows.items()} }")
        if rows["eager"]["graphs"] != 0 or rows["jit"]["graphs"] < 1:
            raise AssertionError(f"graph {name}: graphs {rows['eager']['graphs']} eager, "
                                 f"{rows['jit']['graphs']} jit")
        GRAPH_ROWS[name] = rows
        _, L_, H_, W_ = frames.shape
        log(f"graph {name} {W_}x{H_}x{L_}: SHA-256-equal eager and captured "
            f"({rows['jit']['digests'][0][:16]}, map {rows['jit']['count']}), launches {expect} "
            "in every call, the held result unchanged; " + "; ".join(
                f"{mode}: first {L_ / r['first_s']:.4f} frames/s ({r['first_s']:.4f} s), steady "
                f"{L_ / r['steady_s']:.4f} frames/s ({r['steady_s']:.4f} s), device busy "
                f"{r['busy_s']:.4f} s ({100 * r['busy_s'] / r['steady_s']:.1f}% of the steady "
                f"call), {r['events']} device events, {r['graphs']} graphs captured in "
                f"{r['capture_s']:.4f} s, peak {r['peak_b']} B above the memory allocated before "
                f"the first call" for mode, r in rows.items())
            + f"; {time.perf_counter() - t_path:.2f} s for the path's checks")

    # a gradient row is captured (forward and backward), and an armed row
    rgb, depth, K, P = synthetic_sequence(1, 4, 120, 160, seed=0)
    small = rgbdimages_from_numpy(rgb, depth, K, P, device="cuda")
    d = small.depth_image.clone().requires_grad_()
    grad_slam = PointFusion(odom="gt")
    pc, _ = grad_slam(RGBDImages(small.rgb_image, d, small.intrinsics, small.poses))
    pc.points.sum().backward()
    counts = grad_slam.frame_graphs.counts()
    if not (grad_slam.last_call_captured and counts["forward"] and counts["backward"]):
        raise AssertionError(f"graph gradient row: captured {grad_slam.last_call_captured} "
                             f"({grad_slam.last_eager_reason}), graphs {counts}")
    armed = PointFusion(**dict(ARMED_BASE, map_capacity=4 * 120 * 160), relocalize_below=0.2)
    armed(small)
    keys = sorted({key[0] for key in armed.frame_graphs._entries})
    if not armed.last_call_captured or keys != ["armed"]:
        raise AssertionError(f"graph armed row: captured {armed.last_call_captured} "
                             f"({armed.last_eager_reason}), graphs {keys}")
    if not bool(torch.isfinite(d.grad).all()):
        raise AssertionError("graph gradient row: non-finite gradient")
    log(f"graph: the gradient row ran captured (graphs {counts}), the armed row too (its "
        f"{len(armed.frame_graphs)} graphs: {keys})")
    knn_graph_check(*level_pair(clips["easy"], DSRATIO))


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
    log(conditional_check())
    log(conditional_grad_check())
    t0 = time.perf_counter()
    frameio.load_library()
    log(f"frame decoder library (gradslam_torch/datasets/csrc/frameio.cpp, "
        f"{' '.join(_build.HOST_FLAGS)}) build + load: {time.perf_counter() - t0:.3f} s")

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

    profile_run(lambda: tracked(frames), "gradicp", secs)
    profile_run(lambda: gt(frames), "gt", secs_gt)

    prod, hard_frames, secs_prod = production_phase()
    small_recipe_agrees_with_cpu()
    quantized_headline(frames, pc_gt)
    profile_run(lambda: prod(hard_frames), "production", secs_prod)

    icp_frames, icp_runs = icpslam_phase()
    flat_slam, flat_secs = icp_runs["flat"]
    profile_run(lambda: flat_slam(icp_frames), "icpslam flat", flat_secs)

    t0 = time.perf_counter()
    graph_phase({"easy": frames, "hard": hard_frames, "icp": icp_frames})
    log(f"graph phase: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    knn_new, knn_err, scatter_new = recovery_phase(frames)
    knn["shapes"] += knn_new
    knn["max_abs_err"] = max(knn["max_abs_err"], knn_err)
    scatter["shapes"] += scatter_new
    log(f"recovery phase: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    knn_new, knn_err, scatter_new = semantic_online_phase()
    knn["shapes"] += knn_new
    knn["max_abs_err"] = max(knn["max_abs_err"], knn_err)
    scatter["shapes"] += scatter_new
    log(f"semantic/online phase: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    knn_new, knn_err, scatter_new = dataset_phase()
    knn["shapes"] += knn_new
    knn["max_abs_err"] = max(knn["max_abs_err"], knn_err)
    scatter["shapes"] += scatter_new
    log(f"dataset phase: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    scatter["shapes"] += structures_phase(frames, pc_gt, secs_gt)
    log(f"structures phase: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    scatter["shapes"] += sharded_phase(frames, P)
    log(f"sharded phase: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    loader_phase()
    log(f"loader phase: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    grad_phase()
    log(f"grad phase: {time.perf_counter() - t0:.2f} s")

    left = stop_child_processes()
    log(f"child processes: {len(left)} had to be signalled {left}")

    # launches a run on each path, as counted in its last timed run
    knn_per_path = {path: n["knn"] for path, n in LAUNCHES.items()}
    scatter_per_path = {path: n["scatter"] for path, n in LAUNCHES.items()}

    def grad_split(kernel):  # each gradient step: forward, backward phase
        return {tag: [n["forward"][kernel], n["backward"][kernel]]
                for tag, n in GRAD_LAUNCHES.items()}

    tracked_shape = knn["shapes"][0]
    script = scatter["shapes"][0]
    print(json.dumps({"kernels": [{
        "name": "knn1_cuda",
        "route": "cuda",
        "source": "gradslam_torch/ops/csrc/knn.cu",
        "replaces": "gradslam_tpu/ops/knn_pallas.py:41",
        "launches": sum(knn_per_path.values()),
        "launches_per_path": knn_per_path,
        "grad_launches_forward_backward": grad_split("knn"),
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
        "grad_launches_forward_backward": grad_split("scatter"),
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
    try:
        code = main()
    finally:
        stop_child_processes()  # a failed phase too leaves nothing running
    sys.exit(code)
