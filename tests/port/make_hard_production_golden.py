"""Write the JAX package's CPU run of the production hard-clip recipe, the
golden that ``chip_smoke.py`` holds the port's card run against.

The recipe is ``PRODUCTION`` below (``scripts/bench_all.py:606-612``) on
``hard_sequence(1, 30, 480, 640)``. The file holds the 30 poses, the final
map count, ``num_dropped`` and the Umeyama-aligned ATE. Regenerate it from
the root of the repo with

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/port/make_hard_production_golden.py

(a few minutes and a few GB of memory on the CPU).
"""

import os
import time

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from gradslam_tpu import PointFusion, RGBDImages  # noqa: E402
from gradslam_tpu.datasets import hard_sequence  # noqa: E402
from gradslam_tpu.metrics import ate_rmse  # noqa: E402

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                   "hard_production_640x480_jax_cpu.npz")
B, L, H, W = 1, 30, 480, 640
PRODUCTION = dict(
    odom="gradicp", pyramid=[(8, 6), (8, 4)],
    odom_assoc=["projective", "knn"], odom_sym_normals=True,
    odom_angle_gate=45.0, map_capacity=1_228_800,
    prune_every=4, prune_min_confidence=1.5,
    quantize_colors=True, lookahead_assoc="reuse",
    motion_model="constant_velocity", robust_loss="tukey",
    robust_scale=0.03, dist_thresh=0.01, normal_pitch=4,
)


def main():
    rgb, depth, K, P = hard_sequence(B, L, H, W)
    frames = RGBDImages(jnp.asarray(rgb), jnp.asarray(depth), jnp.asarray(K),
                        jnp.asarray(P))
    t0 = time.perf_counter()
    pc, poses = PointFusion(**PRODUCTION)(frames)
    poses = np.asarray(poses)
    count = int(pc.num_points[0])
    dropped = int(pc.num_dropped[0])
    ate = float(ate_rmse(poses[0], P[0]))
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez(OUT, poses=poses[0], num_points=count, num_dropped=dropped,
             ate_m=ate)
    print(f"{time.perf_counter() - t0:.1f} s: map {count}, dropped {dropped}, "
          f"aligned ATE {ate:.6f} m -> {OUT}")


if __name__ == "__main__":
    main()
