"""Time the port's PointFusion paths on one GPU, to compare two trees of the
port inside one machine call.

    python3 tests/port/time_paths_on_card.py [--root DIR]

imports ``gradslam_torch`` and ``chip_smoke`` from ``DIR`` (default: the
checkout this file is in) and runs the four PointFusion paths of that tree's
``chip_smoke.py`` at their full size, with the clip size, capacity schedule
and production recipe it defines: tracked ``odom='gradicp'`` and
``odom='gt'`` on the 640x480 synthetic clip with the six-segment schedule,
the production recipe on the 640x480 hard clip, and ``odom='gt'`` with
quantized colors. For each path it makes
one warm-up run and three timed runs (host clock, each ending in a
synchronize), then one run under ``torch.profiler``, and prints one JSON
line with the seconds of every timed run, each run's final map count, the
profiled run's device events and device busy seconds (the sum of the
device-side events' own times; they do not overlap on one stream), and the
card's name and power limit. Host-clock times spread by up to 2x between
machine calls, so compare two trees only inside one call, in turns (parent,
change, change, parent); the device events and busy time repeat within
about 1% from call to call.
"""

import argparse
import json
import os
import subprocess
import sys
import time


def main() -> int:
    parser = argparse.ArgumentParser()
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    parser.add_argument("--root", default=here)
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs  # the paths as that tree defines them
    from gradslam_torch import PointFusion, hard_sequence, synthetic_sequence
    from gradslam_torch.interop import rgbdimages_from_numpy

    if not torch.cuda.is_available():
        print("time_paths_on_card: no CUDA device available", file=sys.stderr)
        return 1
    size = (cs.B, cs.L, cs.H, cs.W)
    easy = rgbdimages_from_numpy(*synthetic_sequence(*size, seed=0), device="cuda")
    hard = rgbdimages_from_numpy(*hard_sequence(*size), device="cuda")
    paths = {
        "tracked_easy": (PointFusion(odom="gradicp", dsratio=cs.DSRATIO, numiters=cs.NUMITERS,
                                     map_capacity=cs.SCHEDULE), easy),
        "gt_easy": (PointFusion(odom="gt", map_capacity=cs.SCHEDULE), easy),
        "production_hard": (PointFusion(**cs.PRODUCTION), hard),
        "gt_quantized_easy": (PointFusion(odom="gt", quantize_colors=True,
                                          map_capacity=cs.SCHEDULE), easy),
    }
    out = {"root": os.path.abspath(args.root), "paths": {}}
    for name, (slam, frames) in paths.items():
        slam(frames)
        torch.cuda.synchronize()
        secs, counts = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            pc, _ = slam(frames)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            counts.append(int(pc.num_points[0]))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            slam(frames)
            torch.cuda.synchronize()
        device = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        out["paths"][name] = {
            "seconds": secs, "num_points": counts,
            "device_events": sum(e.count for e in device),
            "device_busy_s": sum(e.self_device_time_total for e in device) / 1e6,
        }
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
