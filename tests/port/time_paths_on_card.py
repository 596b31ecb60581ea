"""Time the port's paths and its two kernels on one GPU, to compare two trees
of the port inside one machine call.

    python3 tests/port/time_paths_on_card.py [--root DIR]

imports ``gradslam_torch`` and ``chip_smoke`` from ``DIR`` (default: the
checkout this file is in) and, with the clip sizes, capacity schedules,
production recipe and ICPSLAM configurations that tree's ``chip_smoke.py``
defines:

- reads the device time of that tree's 1-NN kernel at the paths' three
  shapes (the tracked slice's ds-4 level, N=19,200/M=38,400; the production
  recipe's 1-NN level, N=4,800/M=9,600; ICPSLAM window+pyramid's ds-8 level
  on the 320x240 clip, N=1,200/M=2,400): CUDA events around 20 back-to-back
  calls queued behind a ~10 ms spin kernel, median of 5 rounds, and a
  SHA-256 of the kernel's distances and indices;
- reads that tree's scatter kernel at the six timed shapes of the
  ``chip_smoke.py`` beside this file (``scatter_cases``: the TPU
  microbenchmark's, fusion's winner table and row inversion, ICPSLAM's
  append, the B=2 compaction and ICPSLAM flat's map window), with the same
  inputs for both trees: device time a call (10 calls behind the spin
  kernel, median of 5 rounds), the same for an empty kernel
  (``torch.cuda._sleep(0)``, the launch floor), each device kernel's time
  (``scatter_split_ms``, or the profiler's ``kernel_split_ms`` in a tree
  that predates it), the host time a call
  (``host_us``: 100 calls enqueued behind a spin kernel, median and least
  of 7 rounds) and a SHA-256 of the output;
- runs the four PointFusion paths at their full size (tracked
  ``odom='gradicp'`` and ``odom='gt'`` on the 640x480 synthetic clip with
  the six-segment schedule, the production recipe on the 640x480 hard clip,
  ``odom='gt'`` with quantized colors), the tree's ICPSLAM
  configurations on the 320x240 clip and, where the tree's ``chip_smoke.py``
  defines them, its semantic rows (``SEMANTIC_ROWS`` with
  ``feature_channels=SEM_F`` on the clip with its ``stripe_plane``) and
  online loops (``ONLINE_ROWS``' ``step`` loop at ``ONLINE_CAP``): for
  each one warm-up run and three timed runs (host clock, each ending in a
  synchronize), then one run under ``torch.profiler``.

It prints one JSON line with the seconds of every timed run, each run's
final map count, a SHA-256 of the last run's poses, of its map points and
(where the map carries them) of its features,
the profiled run's device events and device busy seconds (the sum of the
device-side events' own times, and the union of their spans, which does not
count the scatter's dependent launch twice where it overlaps its fill or
copy), the device seconds of the port's scatter kernels (by their names in
either tree) and of device-to-device memcpys in that run, the kernels'
figures, and the card's name and power limit. Host-clock times
spread by up to 2x between machine calls, so compare two trees only inside
one call, in turns (parent, change, change, parent); the device events,
busy time and kernel device times repeat within about 1% from call to
call.
"""

import argparse
import functools
import hashlib
import importlib.util
import json
import os
import subprocess
import sys
import time

# The scatter's device kernels as the profiler names them, in the first
# version (fill_kernel, scatter_kernel; its copy was a runtime memcpy) and in
# the current one (scatter_fill_copy, scatter_rows).
SCATTER_KERNELS = ("::fill_kernel<", "::scatter_kernel<", "::scatter_fill_copy<",
                   "::scatter_rows<")


def sha256(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def main() -> int:
    parser = argparse.ArgumentParser()
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    parser.add_argument("--root", default=here)
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs  # the paths as that tree defines them
    from gradslam_torch import ICPSLAM, PointFusion, hard_sequence, synthetic_sequence
    from gradslam_torch.interop import rgbdimages_from_numpy
    from gradslam_torch.odometry.icputils import downsample_rgbdimages
    from gradslam_torch.ops import knn_cuda

    if not torch.cuda.is_available():
        print("time_paths_on_card: no CUDA device available", file=sys.stderr)
        return 1
    size = (cs.B, cs.L, cs.H, cs.W)
    easy = rgbdimages_from_numpy(*synthetic_sequence(*size, seed=0), device="cuda")
    hard = rgbdimages_from_numpy(*hard_sequence(*size), device="cuda")
    icp = rgbdimages_from_numpy(*synthetic_sequence(cs.B, cs.L, cs.ICP_H, cs.ICP_W, seed=0),
                                device="cuda")
    out = {"root": os.path.abspath(args.root), "knn": {}, "paths": {}}

    def level(frames, ds):
        # frame 1's cloud against frame 0's as a window of twice its rows,
        # the second half NaN padding behind the mask
        pc0 = downsample_rgbdimages(frames[:, 0], ds)
        pc1 = downsample_rgbdimages(frames[:, 1].with_poses(frames.poses[:, 0:1]), ds)
        n = pc0.points.shape[1]
        tgt = torch.cat([pc0.points, torch.full_like(pc0.points, float("nan"))], dim=1)
        mask = torch.arange(2 * n, device=tgt.device)[None] < pc0.num_points[:, None]
        return pc1.points.contiguous(), tgt.contiguous(), mask

    def device_ms(fn, iters=20):
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

    for name, (frames, ds) in {
        "tracked": (easy, cs.DSRATIO),
        "production_level": (hard, cs.PRODUCTION["pyramid"][1][0]),
        "window_pyramid_ds8": (icp, cs.ICPSLAM_CONFIGS["window_pyramid"]["pyramid"][0][0]),
    }.items():
        src, tgt, mask = level(frames, ds)
        d, i = knn_cuda.nn_points_cuda(src, tgt, mask)
        times = [device_ms(lambda: knn_cuda.nn_points_cuda(src, tgt, mask)) for _ in range(5)]
        out["knn"][name] = {"N": src.shape[1], "M": tgt.shape[1],
                            "device_ms": float(np.median(times)), "device_ms_rounds": times,
                            "sha256": sha256(d, i)}

    # the scatter's timed shapes as this file's tree defines them, so both
    # trees get the same inputs
    spec = importlib.util.spec_from_file_location("chip_smoke_here",
                                                  os.path.join(here, "chip_smoke.py"))
    here_cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(here_cs)
    out["scatter"] = {}
    for name, table, dest, values, fill in here_cs.scatter_cases(torch.device("cuda"))[
            :here_cs.SCATTER_TIMED]:
        fn = functools.partial(here_cs.scatter_kernel, table, dest, values, fill)
        result = fn()
        times, floor = [], []
        for _ in range(5):
            times.append(device_ms(fn, 10))
            floor.append(device_ms(lambda: torch.cuda._sleep(0), 10))
        host = [here_cs.host_us(fn) for _ in range(7)]
        out["scatter"][name] = {
            "device_ms": float(np.median(times)), "device_ms_rounds": times,
            "floor_ms": float(np.median(floor)),
            "host_us": float(np.median(host)), "host_us_min": float(min(host)),
            "kernels_ms": (here_cs.scatter_split_ms(table, dest, values, fill)
                           if hasattr(here_cs, "scatter_split_ms")
                           else here_cs.kernel_split_ms(fn)),
            "bound_ms": here_cs.scatter_bound(table, dest, values), "sha256": sha256(result)}

    paths = {
        "tracked_easy": (PointFusion(odom="gradicp", dsratio=cs.DSRATIO, numiters=cs.NUMITERS,
                                     map_capacity=cs.SCHEDULE), easy),
        "gt_easy": (PointFusion(odom="gt", map_capacity=cs.SCHEDULE), easy),
        "production_hard": (PointFusion(**cs.PRODUCTION), hard),
        "gt_quantized_easy": (PointFusion(odom="gt", quantize_colors=True,
                                          map_capacity=cs.SCHEDULE), easy),
    }
    for name, kw in cs.ICPSLAM_CONFIGS.items():
        paths[f"icpslam_{name}"] = (ICPSLAM(map_capacity=cs.ICP_SCHEDULE, **kw), icp)
    runs = {name: functools.partial(slam, frames) for name, (slam, frames) in paths.items()}
    for name, (cls, shape, kw) in getattr(cs, "SEMANTIC_ROWS", {}).items():
        _, sem, _ = cs.semantic_frames(shape)
        slam = {"PointFusion": PointFusion, "ICPSLAM": ICPSLAM}[cls](
            feature_channels=cs.SEM_F, **kw)
        runs[f"semantic_{name}"] = functools.partial(slam, sem)
    for name, kw in getattr(cs, "ONLINE_ROWS", {}).items():
        plain, sem, _ = cs.semantic_frames(size)
        slam = PointFusion(map_capacity=cs.ONLINE_CAP, **kw)
        runs[f"online_{name}_step"] = functools.partial(
            cs.step_loop, slam, sem if kw.get("feature_channels") else plain,
            kw.get("motion_model") == "constant_velocity")
    for name, run in runs.items():
        run()
        torch.cuda.synchronize()
        secs, counts = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            pc, poses = run()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            counts.append(int(pc.num_points[0]))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        device = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]

        def device_s(*keys):
            return sum(e.self_device_time_total for e in device
                       if any(k in e.key for k in keys)) / 1e6

        out["paths"][name] = {
            "scatter_device_s": device_s(*SCATTER_KERNELS),
            "memcpy_dtod_s": device_s("Memcpy DtoD"),
            "seconds": secs, "num_points": counts,
            "poses_sha256": sha256(poses),
            "points_sha256": sha256(*(pc.points[b, :int(pc.num_points[b])]
                                      for b in range(pc.points.shape[0]))),
            "features_sha256": None if pc.features is None else sha256(
                *(pc.features[b, :int(pc.num_points[b])] for b in range(pc.points.shape[0]))),
            "device_events": sum(e.count for e in device),
            "device_busy_s": sum(e.self_device_time_total for e in device) / 1e6,
            "device_busy_union_s": here_cs.device_busy_s(prof),
        }
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
