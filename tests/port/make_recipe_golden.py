"""Write the JAX package's CPU run of the production recipe at 160x120x9,
the golden ``tests/port/test_torch_recipe.py::test_recipe_whole_run_matches_jax``
holds the port's whole run against.

The recipe and the clip are that test module's (``RECIPE`` on
``hard_sequence(1, 9, 120, 160)``). The file holds the clip's SHA-256 (the
test checks it is the clip it runs), the nine poses, the final map count,
``num_dropped`` and the unaligned ATE. Regenerate it from the root of the
repo with

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/port/make_recipe_golden.py

(about 20 s on the CPU).
"""

import time

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import gradslam_tpu as G  # noqa: E402
from tests.port import test_torch_recipe as R  # noqa: E402


def main():
    clip = R.hard_sequence(1, R.L, R.H, R.W)
    t0 = time.perf_counter()
    pc, poses = G.PointFusion(**R.RECIPE)(G.RGBDImages(*(jnp.asarray(a) for a in clip)))
    poses = np.asarray(poses)
    np.savez(R.GOLDEN, clip_sha256=R.clip_sha256(clip), poses=poses,
             num_points=int(pc.num_points[0]), num_dropped=int(pc.num_dropped[0]),
             ate_m=float(G.metrics.ate_rmse(poses[0], clip[3][0])))
    print(f"{time.perf_counter() - t0:.1f} s -> {R.GOLDEN}")


if __name__ == "__main__":
    main()
