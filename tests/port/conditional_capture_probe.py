"""CUDA graph conditional (IF) nodes on one card: what
``gradslam_torch/utils/graphs.py``'s ``when`` relies on to capture the armed
frame's recovery branches.

Run on the card: ``python3 tests/port/conditional_capture_probe.py``. It
prints torch's, CUDA's, ``nvcc``'s and the driver's versions, whether
torch's ``CUDAGraph`` has its own conditional nodes
(``begin_capture_to_if_node``; torch 2.11.0+cu128 has not, nvcc 12.9 and
driver 580.159.03 beside it) and which of the allocator hooks ``when``
uses it has (that torch has all four). Then, through ``FrameGraphs``, it
warms up and captures a body with two ``when``\\ s whose IF nodes hold what
the recovery branches launch (the 1-NN kernel, batched 4x4 products through
cuBLAS, a compaction by ``cumsum`` and ``scatter_``, fresh allocations,
``torch.where``); the second node's predicate depends on what the first
wrote. It replays with each predicate true and false against the same body
decided on the host, bit for bit, with the 1-NN launches that ``settle``
adds against the host's, and times 200 replays whose IF nodes are both
false against 200 whose are both true (host clock, synchronized).
"""

import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from gradslam_torch.ops import knn_cuda  # noqa: E402
from gradslam_torch.ops.knn_cuda import nn_points_cuda  # noqa: E402
from gradslam_torch.utils.graphs import FrameGraphs, when  # noqa: E402


def branch(src, tgt, A, scale):
    d, idx = nn_points_cuda(src * scale, tgt)
    P = torch.bmm(A, A.transpose(1, 2))
    keep = d < d.median(dim=-1, keepdim=True).values
    pos = torch.cumsum(keep.to(torch.int64), dim=-1) - 1
    n = src.shape[1]
    # kept rows to the front in order, the rest each to a slot of its own:
    # no two writes meet, so the sum below is deterministic
    slot = torch.where(keep, pos, n + torch.arange(n, device=src.device))
    scratch = torch.zeros(src.shape[0], 2 * n, dtype=src.dtype, device=src.device)
    scratch.scatter_(1, slot, d)
    return P.sum((1, 2)) + scratch[:, :n].sum(-1), idx.to(torch.int64).sum(-1)


def body(src, tgt, A, gate, decide):
    outs = [torch.zeros(src.shape[0], dtype=src.dtype, device=src.device),
            torch.zeros(src.shape[0], dtype=torch.int64, device=src.device)]
    pred1 = gate[0] > 0
    outs = decide(pred1, branch, (src, tgt, A, 1.0), outs)
    pred2 = (outs[0].sum() != 0) & (gate[1] > 0)
    outs = decide(pred2, branch, (src, tgt, A, 2.0), outs)
    return outs


def on_host(pred, fn, args, outs):
    return list(fn(*args)) if bool(pred) else outs


def main():
    nvcc = subprocess.run(["/usr/local/cuda/bin/nvcc", "--version"], capture_output=True,
                          text=True).stdout.strip().splitlines()
    print("torch", torch.__version__, "cuda", torch.version.cuda, "|", nvcc[-1] if nvcc else "",
          flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,driver_version",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    print("torch CUDAGraph.begin_capture_to_if_node:",
          hasattr(torch.cuda.CUDAGraph, "begin_capture_to_if_node"))
    for name in ("_cuda_beginAllocateCurrentStreamToPool",
                 "_cuda_beginAllocateCurrentThreadToPool", "_cuda_endAllocateToPool",
                 "_cuda_releasePool"):
        print(name, hasattr(torch._C, name))
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(0)
    B, N, M = 2, 4800, 9600
    src = torch.randn(B, N, 3, generator=g).cuda()
    tgt = torch.randn(B, M, 3, generator=g).cuda()
    A = torch.randn(B, 4, 4, generator=g).cuda()
    graphs = FrameGraphs()
    ok = True
    for gates in ((1.0, 1.0), (0.0, 1.0), (1.0, 0.0), (0.0, 0.0), (1.0, 1.0), (0.0, 1.0)):
        gate = torch.tensor(gates).cuda()
        knn_cuda.launches = 0
        got = [t.clone() for t in graphs("probe", lambda *a: body(*a, when), (src, tgt, A, gate))]
        took = graphs.settle()
        launches = knn_cuda.launches
        knn_cuda.launches = 0
        want = body(src, tgt, A, gate, on_host)
        same = all(torch.equal(x, y) for x, y in zip(got, want)) and launches == knn_cuda.launches
        ok &= same
        print(f"gate {gates}: predicates {took}, 1-NN launches {launches} (host "
              f"{knn_cuda.launches}), equal to the host's bits {same}", flush=True)
    print("graphs", graphs.counts(), "replays", graphs.replays)
    for g0 in (0.0, 1.0):
        gate = torch.full((2,), g0).cuda()
        graphs("probe", lambda *a: body(*a, when), (src, tgt, A, gate))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            graphs("probe", lambda *a: body(*a, when), (src, tgt, A, gate))
        torch.cuda.synchronize()
        graphs.settle()
        print(f"replay with both IF nodes {'true' if g0 else 'false'}: "
              f"{(time.perf_counter() - t0) / 200 * 1e3:.4f} ms", flush=True)
    print("PROBE", "ok" if ok else "MISMATCH")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
