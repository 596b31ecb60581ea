"""NCCL collectives inside the port's CUDA graphs, at world size 1 on one
card: what ``gradslam_torch/utils/graphs.py`` relies on to capture
``MapShardedPointFusion``'s frame body.

Run on the card: ``python3 tests/port/nccl_capture_probe.py``. For a fresh
process group (``init_process_group('nccl')`` with a ``file://`` store, no
network) whose first collective runs inside a ``FrameGraphs`` warm-up
(under the sync debug mode "error"), and for one whose communicator an
eager collective made first, it

- warms up and captures a body of an all-gather and an all-reduce through
  ``parallel.collectives`` and prints the collectives' tallies;
- replays it on new inputs against the eager body, bit for bit;
- times 200 replays and 200 eager calls (host clock, synchronized);
- prints each device event of one replayed and one eager call with the
  stream the profiler gives it, and the capture stream's handle;
- captures a second key right after five eager calls (the warm-up's
  collectives still fresh for NCCL's watchdog);
- destroys the group and prints how long that took.

It prints torch's, CUDA's and NCCL's versions first.
"""

import os
import sys
import tempfile
import time

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from gradslam_torch.parallel import collectives  # noqa: E402
from gradslam_torch.utils.graphs import FrameGraphs  # noqa: E402


def body_of(group):
    def body(x):
        gathered = collectives.all_gather(x * 2, group, "gather")
        reduced = collectives.all_reduce(x, group, "reduce", op=dist.ReduceOp.MAX)
        return gathered.sum(0) + reduced
    return body


def device_events(run) -> list:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    return [(e.name()[:80], e.device_resource_id()) for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA]


def trial(tag: str, connect_first: bool) -> None:
    store = tempfile.mkdtemp()
    dist.init_process_group("nccl", init_method=f"file://{store}/store", rank=0, world_size=1)
    try:
        group = dist.group.WORLD
        x = torch.randn(100_000, device="cuda")
        if connect_first:
            dist.all_reduce(torch.zeros(1, device="cuda"))
        graphs, body = FrameGraphs(), body_of(group)
        collectives.reset_counts()
        graphs("body", body, (x,))
        print(tag, "warm-up and capture: graphs", len(graphs), "tallies",
              dict(collectives.BYTES), dict(collectives.CALLS), flush=True)
        for i in range(3):
            y = torch.randn(100_000, device="cuda")
            want = body(y.clone())
            got = graphs("body", body, (y,)).clone()
            print(tag, "replay", i, "bit-equal to eager:", torch.equal(got, want), flush=True)
        for what, run in (("replay", lambda: graphs("body", body, (x,))), ("eager", lambda: body(x))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                run()
            torch.cuda.synchronize()
            print(tag, what, "µs a call:", (time.perf_counter() - t0) / 200 * 1e6, flush=True)
        for what, run in (("replay", lambda: graphs("body", body, (x,))), ("eager", lambda: body(x))):
            for name, stream in device_events(run):
                print(tag, what, "device event", name, "stream", stream, flush=True)
        print(tag, "capture stream handle", graphs._stream.cuda_stream, "current stream handle",
              torch.cuda.current_stream().cuda_stream, flush=True)
        z = torch.randn(5_000, device="cuda")
        for _ in range(5):
            body(z)
        graphs("body", body, (z,))
        print(tag, "a second key captured right after eager collectives: graphs", len(graphs),
              flush=True)
    finally:
        t0 = time.perf_counter()
        dist.destroy_process_group()
        print(tag, "group destroyed in", time.perf_counter() - t0, "s", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("nccl_capture_probe: no CUDA device", file=sys.stderr)
        return 1
    print("python", sys.version.split()[0], "torch", torch.__version__, "cuda", torch.version.cuda,
          "nccl", torch.cuda.nccl.version(), flush=True)
    trial("fresh", connect_first=False)
    trial("connected", connect_first=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
