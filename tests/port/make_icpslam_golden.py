"""Write the JAX package's CPU runs of the ICPSLAM slice, the golden that
``chip_smoke.py`` holds the port's card runs against.

The configurations are ``CONFIGS`` below (``scripts/bench_all.py:223-246``)
and ``ICPSLAM(odom='gt')``, each on ``synthetic_sequence(1, 30, 240, 320)``
with the six-segment capacity schedule. For each, the file holds the 30
poses (``<name>_poses``), the final map count (``<name>_num_points``),
``<name>_num_dropped``, the Umeyama-aligned ATE (``<name>_ate_m``, the
``ate_rmse`` of ``scripts/bench_all.py``) and the unaligned translation RMSE
against the clip's poses (``<name>_ate_unaligned_m``). Regenerate it from the
root of the repo with

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/port/make_icpslam_golden.py

(a few minutes and a few GB of memory on the CPU).
"""

import os
import time

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from gradslam_tpu import ICPSLAM, RGBDImages  # noqa: E402
from gradslam_tpu.datasets import synthetic_sequence  # noqa: E402
from gradslam_tpu.metrics import ate_rmse  # noqa: E402

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                   "icpslam_320x240_jax_cpu.npz")
B, L, H, W = 1, 30, 240, 320
SCHEDULE = [(5, (i + 1) * 5 * H * W) for i in range(6)]
CONFIGS = {
    "flat": dict(odom="icp", dsratio=4, numiters=10),
    "window": dict(odom="icp", dsratio=4, numiters=10, icp_window_frames=2),
    "window_pyramid": dict(odom="icp", pyramid=[(8, 8), (4, 3)], icp_window_frames=2),
    "gt": dict(odom="gt"),
}


def main():
    rgb, depth, K, P = synthetic_sequence(B, L, H, W)
    frames = RGBDImages(jnp.asarray(rgb), jnp.asarray(depth), jnp.asarray(K),
                        jnp.asarray(P))
    out = {}
    for name, kw in CONFIGS.items():
        t0 = time.perf_counter()
        pc, poses = ICPSLAM(map_capacity=SCHEDULE, **kw)(frames)
        poses = np.asarray(poses)[0]
        err = poses[:, :3, 3].astype(np.float64) - P[0, :, :3, 3].astype(np.float64)
        out[f"{name}_poses"] = poses
        out[f"{name}_num_points"] = int(pc.num_points[0])
        out[f"{name}_num_dropped"] = int(pc.num_dropped[0])
        out[f"{name}_ate_m"] = float(ate_rmse(poses, P[0]))
        out[f"{name}_ate_unaligned_m"] = float(np.sqrt(np.mean(np.sum(err**2, axis=-1))))
        print(f"{name}: {time.perf_counter() - t0:.1f} s, map {out[f'{name}_num_points']}, "
              f"dropped {out[f'{name}_num_dropped']}, aligned ATE {out[f'{name}_ate_m']:.4e} m, "
              f"unaligned {out[f'{name}_ate_unaligned_m']:.4e} m", flush=True)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez(OUT, **out)
    print(f"-> {OUT}")


if __name__ == "__main__":
    main()
