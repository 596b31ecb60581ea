"""Time the armed gradient step without remat on one GPU, to compare two trees
of the port inside one machine call.

    python3 tests/port/time_armed_grad_on_card.py [--root DIR] [--steps N]
        [--profile] [--mixed]

imports ``gradslam_torch`` and ``chip_smoke`` from ``DIR`` (default: the
checkout this file is in) and, for each of that tree's ``ARMED_GRAD_ROWS``
(the kidnap 1-NN row at 640x480x11, and the same row with the anchor
armed), builds ``PointFusion`` with ``use_jit=True, remat=False`` (the JAX
package's default) and the row's options, and runs ``N`` gradient steps
(default 5) of that tree's ``grad_step`` (the forward, ``sum(points^2)`` of
the map, its backward to the depths and the intrinsics) on the row's
inputs: the seconds of each step (host clock, ending in a synchronize), the
host reads of each step (that tree's ``ReadBacks``), its launches, and a
SHA-256 of its poses, map and gradients. The first steps warm up and
capture; later ones replay.

``--profile`` adds one more steady step under ``torch.profiler`` (device
activity only): its device busy seconds (the union of the events' spans),
events, and each kernel name's events and device seconds, the largest
first. ``--mixed`` (a tree whose ``FrameGraphs`` has ``regrows``) then runs,
on a new pipeline of the anchored row, steps that alternate between the
kidnap clip (the relocalization on frame 8 and the refreshes) and the easy
clip at the same shape (the refreshes only), starting on the easy one: the
seconds, reads and store regrowths of each step and how many poses and
map digests each clip's steps gave; and two forwards (kidnap, easy) before one backward of
their summed losses, captured against the same eagerly.

It prints one JSON line with these and the card's name and power limit
(and one more for ``--mixed``).
Host-clock times spread between machine calls, so compare two trees only
inside one call, in turns (parent, change, change, parent).
"""

import argparse
import collections
import gc
import json
import os
import sys
import time

MIXED = ("easy", "easy", "kidnap", "kidnap", "easy", "kidnap", "easy", "kidnap")


def device_profile(run) -> dict:
    """One call of ``run`` under ``torch.profiler``, the device's activity
    only: busy seconds, events and the kernels by name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    events = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CUDA]
    spans = sorted((e.start_ns(), e.start_ns() + e.duration_ns()) for e in events)
    busy, end = 0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    by_name = collections.defaultdict(lambda: [0, 0])
    for e in events:
        by_name[e.name()][0] += 1
        by_name[e.name()][1] += e.duration_ns()
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    return dict(wall_s=wall, busy_s=busy * 1e-9, events=len(events),
                kernels=[[name, n, ns * 1e-9] for name, (n, ns) in top[:60]],
                other_s=sum(ns for _, (_, ns) in top[60:]) * 1e-9)


def timed_step(c, slam, inputs):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with c.ReadBacks(slam) as read_backs:
        out = c.grad_step(slam, inputs)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, sum(read_backs.reads.values())


def mixed(c, torch) -> dict:
    """The anchored row's steps over clips whose branches differ, and two
    forwards before one backward."""
    name = c.ARMED_GRAD_ROWS[-1]
    shape, cap, kw, _ = c.GRAD_ROWS[name]
    clips = {"kidnap": c.row_inputs(name, "cuda"), "easy": c.grad_inputs(shape, "cuda")}
    slam = c.PointFusion(map_capacity=cap, remat=False, use_jit=True, **kw)
    steps, digests = [], collections.defaultdict(set)
    for clip in MIXED:
        regrows = slam.frame_graphs.regrows
        out, secs, reads = timed_step(c, slam, clips[clip])
        digests[clip].add(c.grad_digests(out)[0])  # poses and map (atomic adds move gradients)
        steps.append(dict(clip=clip, s=secs, reads=reads,
                          regrows=slam.frame_graphs.regrows - regrows,
                          store_b=slam.frame_graphs.store_bytes(),
                          pushed_b=slam.frame_graphs.pushed_bytes))
        del out

    def two(pipeline):
        """Maps and poses of both forwards, and the gradients of their
        summed losses."""
        loss, outs, leaves = 0, [], []
        for clip in ("kidnap", "easy"):
            rgb, depth, K, P = clips[clip]
            d, k = depth.clone().requires_grad_(), K.clone().requires_grad_()
            pc, poses = pipeline(c.RGBDImages(rgb, d, k, P))
            loss = loss + (pc.points ** 2).sum()
            outs += [poses.detach(), pc.points.detach()]
            leaves += [d, k]
        loss.backward()
        torch.cuda.synchronize()
        return outs, [t.grad for t in leaves]

    regrows = slam.frame_graphs.regrows
    t0 = time.perf_counter()
    got = two(slam)
    two_s = time.perf_counter() - t0
    want = two(c.PointFusion(map_capacity=cap, remat=False, use_jit=False, **kw))
    two_forwards = dict(
        s=two_s, regrows=slam.frame_graphs.regrows - regrows,
        maps_equal=c.sha256_of(*got[0]) == c.sha256_of(*want[0]),
        grad_gaps=[c.rel_gap(a, b) for a, b in zip(got[1], want[1])])
    return dict(row=name, steps=steps, digests={k: len(v) for k, v in digests.items()},
                two_forwards=two_forwards)


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    parser.add_argument("--steps", type=int, default=5)
    parser.add_argument("--profile", action="store_true")
    parser.add_argument("--mixed", action="store_true")
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    import chip_smoke as c

    if not torch.cuda.is_available():
        print("time_armed_grad_on_card: no CUDA device available", file=sys.stderr)
        return 1
    c.disable_tf32()
    c.load_library()
    rows = {}
    for name in c.ARMED_GRAD_ROWS:
        _, cap, kw, _ = c.GRAD_ROWS[name]
        inputs = c.row_inputs(name, "cuda")
        slam = c.PointFusion(map_capacity=cap, remat=False, use_jit=True, **kw)
        secs, reads, launches, digests = [], [], [], []
        for _ in range(args.steps):
            out, s, n = timed_step(c, slam, inputs)
            secs.append(s)
            reads.append(n)
            launches.append(out[4])
            digests.append(c.grad_digests(out))
            del out
        rows[name] = dict(secs=secs, reads=reads, launches=launches,
                          digests=sorted(set(digests)), graphs=slam.frame_graphs.counts(),
                          regrows=getattr(slam.frame_graphs, "regrows", None),
                          captured=slam.last_call_captured)
        if args.profile:
            rows[name]["profile"] = device_profile(lambda: c.grad_step(slam, inputs))
        del slam, inputs
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps({"root": os.path.abspath(args.root), "card": c.card_line(),
                      "torch": torch.__version__, "rows": rows}), flush=True)
    if args.mixed:
        print(json.dumps({"mixed": mixed(c, torch)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
