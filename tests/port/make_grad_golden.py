"""Write the JAX package's CPU gradients of two differentiable SLAM runs, the
golden that ``chip_smoke.py`` holds the port's card gradients against.

Each run is ``jax.grad`` of ``sum(points ** 2)`` of the final map with
respect to the depth images and the intrinsics, through
``PointFusion(..., remat=True)`` on ``synthetic_sequence(B, L, H, W,
seed=0)`` (``scripts/bench_all.py:721-840``):

- ``gt``: ``odom='gt'`` at 640x480x30, capacity 540,672;
- ``knn``: ``odom='gradicp'``, ``dsratio=4``, ``numiters=10`` at 320x240x30,
  capacity 147,456.

For each ``<name>``, the file holds the inputs' description (``_shape`` =
``(B, L, H, W)``, ``_seed``, ``_capacity``, ``_config``: the other
constructor options as JSON, ``_depth_sha256`` of the float32 depth bytes), the loss (``_loss``), the map count (``_num_points``), the
intrinsics gradient (``_grad_K``, ``(B, 1, 4, 4)``), the depth gradient's
sum, absolute sum and largest magnitude (``_grad_depth_sum``,
``_grad_depth_abssum``, ``_grad_depth_maxabs``), and its values
(``_grad_depth_at``) at 4,096 flat pixel indices (``_pix``, into the
``(B, L, H, W)`` depth, drawn from ``RandomState(0)``). Regenerate it from
the root of the repo with

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/port/make_grad_golden.py

(about 5 minutes and a few GB of memory on the CPU).
"""

import hashlib
import json
import os
import time

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from gradslam_tpu import PointFusion, RGBDImages  # noqa: E402
from gradslam_tpu.datasets import synthetic_sequence  # noqa: E402

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "grad_jax_cpu.npz")
SEED = 0
PIXELS = 4096
CONFIGS = {
    "gt": ((1, 30, 480, 640), 540_672, dict(odom="gt")),
    "knn": ((1, 30, 240, 320), 147_456, dict(odom="gradicp", dsratio=4, numiters=10)),
}


def depth_digest(depth: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(depth, dtype=np.float32).tobytes()).hexdigest()


def pixels(shape) -> np.ndarray:
    return np.sort(np.random.RandomState(0).choice(int(np.prod(shape)), PIXELS, replace=False))


def main():
    out = {}
    for name, (shape, cap, kw) in CONFIGS.items():
        t0 = time.perf_counter()
        rgb, depth, K, P = synthetic_sequence(*shape, seed=SEED)
        slam = PointFusion(use_jit=False, remat=True, map_capacity=cap, **kw)
        rgb_j, P_j = jnp.asarray(rgb), jnp.asarray(P)

        def loss_fn(d, k):
            pc, _ = slam.forward(RGBDImages(rgb_j, d, k, P_j))
            return jnp.sum(pc.points ** 2), pc.num_points

        (loss, count), (gd, gk) = jax.jit(jax.value_and_grad(
            loss_fn, argnums=(0, 1), has_aux=True))(jnp.asarray(depth), jnp.asarray(K))
        gd = np.asarray(gd, dtype=np.float32).reshape(shape)
        pix = pixels(shape)
        out[f"{name}_shape"] = np.asarray(shape)
        out[f"{name}_seed"] = SEED
        out[f"{name}_capacity"] = cap
        out[f"{name}_config"] = json.dumps(kw, sort_keys=True)
        out[f"{name}_depth_sha256"] = depth_digest(depth)
        out[f"{name}_loss"] = float(loss)
        out[f"{name}_num_points"] = int(count[0])
        out[f"{name}_grad_K"] = np.asarray(gk, dtype=np.float32)
        out[f"{name}_grad_depth_sum"] = float(gd.astype(np.float64).sum())
        out[f"{name}_grad_depth_abssum"] = float(np.abs(gd.astype(np.float64)).sum())
        out[f"{name}_grad_depth_maxabs"] = float(np.abs(gd).max())
        out[f"{name}_pix"] = pix
        out[f"{name}_grad_depth_at"] = gd.reshape(-1)[pix]
        print(f"{name}: {time.perf_counter() - t0:.1f} s, loss {float(loss):.6e}, map "
              f"{int(count[0])}, max |g_depth| {out[f'{name}_grad_depth_maxabs']:.6e}, "
              f"max |g_K| {float(np.abs(out[f'{name}_grad_K']).max()):.6e}", flush=True)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez(OUT, **out)
    print(f"-> {OUT}")


if __name__ == "__main__":
    main()
