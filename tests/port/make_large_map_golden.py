"""Write the JAX package's CPU runs of the large-map cell, the golden that
``chip_smoke.py`` holds the port's card runs against.

The cell is ``scripts/bench_all.py:633-680``: ``synthetic_sequence(1, 60,
480, 640, speed=4.0)`` with the six-segment schedule ``LARGE_SCHEDULE``
(last segment 1,160,192 rows) and the three pipelines of ``LARGE_ROWS``
(gt, gt with quantized colors, tracked projective pyramid), all taken from
``chip_smoke.py``. For each ``<name>`` the file holds the 60 poses
(``<name>_poses``), the final map count (``<name>_num_points``),
``<name>_num_dropped``, the Umeyama-aligned ATE (``<name>_ate_m``) and the
unaligned translation RMSE (``<name>_ate_unaligned_m``). Regenerate it from
the root of the repo with

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/port/make_large_map_golden.py

(about 15 minutes and a few GB of memory on the CPU).
"""

import os
import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import chip_smoke as cs  # noqa: E402
from gradslam_tpu import PointFusion, RGBDImages  # noqa: E402
from gradslam_tpu.datasets import synthetic_sequence  # noqa: E402
from gradslam_tpu.metrics import ate_rmse  # noqa: E402

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "large_map_jax_cpu.npz")


def run_row(out: dict, name: str, frames, P: np.ndarray, **kw) -> None:
    """One pipeline run; its poses, map count and errors go into ``out``."""
    t0 = time.perf_counter()
    pc, poses = PointFusion(**kw)(frames)
    poses = np.asarray(poses)[0]
    err = poses[:, :3, 3].astype(np.float64) - P[0, :, :3, 3].astype(np.float64)
    out[f"{name}_poses"] = poses
    out[f"{name}_num_points"] = int(pc.num_points[0])
    out[f"{name}_num_dropped"] = int(pc.num_dropped[0])
    out[f"{name}_ate_m"] = float(ate_rmse(poses, P[0]))
    out[f"{name}_ate_unaligned_m"] = float(np.sqrt(np.mean(np.sum(err**2, axis=-1))))
    print(f"{name}: {time.perf_counter() - t0:.1f} s, map {out[f'{name}_num_points']}, dropped "
          f"{out[f'{name}_num_dropped']}, aligned ATE {out[f'{name}_ate_m']:.4e} m, unaligned "
          f"{out[f'{name}_ate_unaligned_m']:.4e} m", flush=True)


def main():
    rgb, depth, K, P = synthetic_sequence(*cs.LARGE_SHAPE, speed=cs.LARGE_SPEED)
    frames = RGBDImages(jnp.asarray(rgb), jnp.asarray(depth), jnp.asarray(K), jnp.asarray(P))
    out = {}
    for name, kw in cs.LARGE_ROWS.items():
        run_row(out, name, frames, P, map_capacity=cs.LARGE_SCHEDULE, **kw)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez(OUT, **out)
    print(f"-> {OUT}")


if __name__ == "__main__":
    main()
