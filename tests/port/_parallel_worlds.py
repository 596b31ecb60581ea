"""Spawned gloo worlds for the parallel tests.

A test module runs its cases in one world of ``K`` CPU processes
(:func:`spawn_world`): ``torch.multiprocessing.spawn`` with a ``file://``
store under the test's temporary directory, so the pytest process never
initialises a process group. The children import no JAX: each runs every
case of a suite (a module-level dict of functions taking the world's
meshes) and writes what it returns, numpy arrays, to ``rank<r>.npz``; a
case that raises writes its error as ``<case>__error``. The parent loads
the files and holds them against the JAX package.

:func:`frames_np` is ``tests/parallel/test_sharding.py``'s
``synthetic_frames`` in numpy: the same draws from the same seed.
"""

import os
import traceback

import numpy as np


def frames_np(B, L=2, H=16, W=24, seed=0):
    """``(rgb, depth, intrinsics, poses)`` numpy arrays."""
    rng = np.random.RandomState(seed)
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    base = 1.5 + 0.3 * np.sin(xs / 13.0) + 0.2 * np.cos(ys / 9.0)
    depths = np.stack(
        [[base + 0.02 * rng.rand(H, W) for _ in range(L)] for _ in range(B)]
    )[..., None].astype(np.float32)
    rgb = rng.rand(B, L, H, W, 3).astype(np.float32)
    K = np.eye(4, dtype=np.float32)
    K[0, 0] = K[1, 1] = 0.8 * W
    K[0, 2], K[1, 2] = (W - 1) / 2, (H - 1) / 2
    intrinsics = np.tile(K, (B, 1, 1, 1))
    poses = np.tile(np.eye(4, dtype=np.float32), (B, L, 1, 1))
    return rgb, depths, intrinsics, poses


def labels_np(B, L, H, W):
    """The JAX tests' two-class feature plane: left half 1, right half 1."""
    lab = np.zeros((B, L, H, W, 2), np.float32)
    lab[..., : W // 2, 0] = 1.0
    lab[..., W // 2:, 1] = 1.0
    return lab


def torch_frames(*arrays, feature_image=None, channels_first=False):
    from gradslam_torch.interop import rgbdimages_from_numpy

    return rgbdimages_from_numpy(*arrays, device="cpu", feature_image=feature_image,
                                 channels_first=channels_first)


def _child(rank, world, store, outdir, suite_module, suite_name):
    import importlib

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world)
    try:
        suite = getattr(importlib.import_module(suite_module), suite_name)
        ctx = suite["setup"]()
        out = {}
        for name, case in suite["cases"].items():
            try:
                for key, value in case(ctx).items():
                    out[f"{name}__{key}"] = np.asarray(value)
            except Exception as e:  # recorded for the parent to assert on
                out[f"{name}__error"] = np.asarray(f"{type(e).__name__}: {e}")
                out[f"{name}__trace"] = np.asarray(traceback.format_exc())
        np.savez(os.path.join(outdir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def spawn_world(world, tmpdir, suite_module, suite_name):
    """Start the world; returns ``join()``, which waits for it and returns
    each rank's results as a dict ``{case: {key: array}}``."""
    import torch.multiprocessing as mp

    tmpdir = str(tmpdir)
    ctx = mp.spawn(_child, args=(world, os.path.join(tmpdir, "store"), tmpdir, suite_module,
                                 suite_name), nprocs=world, join=False)

    def join():
        while not ctx.join():
            pass
        ranks = []
        for r in range(world):
            with np.load(os.path.join(tmpdir, f"rank{r}.npz")) as z:
                res = {}
                for key in z.files:
                    case, field = key.split("__", 1)
                    res.setdefault(case, {})[field] = z[key]
                ranks.append(res)
        return ranks

    return join


def value(ranks, case, key, rank=0):
    """One rank's result, failing with the child's traceback if the case
    raised."""
    res = ranks[rank][case]
    if key not in res and "error" in res:
        raise AssertionError(f"{case} raised on rank {rank}:\n{res['trace']}")
    return res[key]
