"""Write the JAX package's CPU runs of the map-sharded rows, the golden that
``chip_smoke.py``'s sharded phase holds the port's card runs against.

Each row of ``chip_smoke.SHARDED_ROWS`` (gt, gradICP with 1-NN association,
gradICP with projective association) runs ``MapShardedPointFusion`` with
``map_capacity = SHARDED_CAP`` on a ``SHARDED_GOLDEN_K``-device virtual CPU
mesh over ``synthetic_sequence(1, 30, 480, 640, seed=0)``, each shard with
the default ICP window (``2 * 120 * 160`` rows at ``dsratio=4``: a quarter
of it a shard loses the track, ATE 5.4 cm at 120x160). For each ``<name>`` the
file holds the 30 poses (``<name>_poses``), each shard's live count
(``<name>_shard_counts``), the map count (``<name>_num_points``),
``<name>_num_dropped``, the confidence mass (``<name>_mass``, the sum of
the live rows' ccount), the Umeyama-aligned ATE (``<name>_ate_m``), and the
row's constructor arguments (``<name>_config``, JSON) and the clip's shape.
The file is rewritten after each row. Regenerate it from the root of the
repo with

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/port/make_sharded_golden.py

(the gt and projective rows take about 10 s each; the 1-NN row about two
hours of CPU, its replicated solve searching 4 windows of 38,400 rows on
each of the 4 virtual devices; a few GB of memory).
"""

import json
import os
import sys
import time

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import chip_smoke as cs  # noqa: E402
from gradslam_tpu import RGBDImages  # noqa: E402
from gradslam_tpu.datasets import synthetic_sequence  # noqa: E402
from gradslam_tpu.metrics import ate_rmse  # noqa: E402
from gradslam_tpu.parallel import MapShardedPointFusion, make_mesh  # noqa: E402

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "sharded_jax_cpu.npz")
ORDER = ("gt", "projective", "knn")  # the cheap rows first


def row_kwargs(name: str) -> dict:
    return dict(cs.SHARDED_ROWS[name], map_capacity=cs.SHARDED_CAP)


def main():
    shape = (1, cs.L, cs.H, cs.W)
    rgb, depth, K, P = synthetic_sequence(*shape, seed=0)
    frames = RGBDImages(jnp.asarray(rgb), jnp.asarray(depth), jnp.asarray(K), jnp.asarray(P))
    mesh = make_mesh(jax.devices()[:cs.SHARDED_GOLDEN_K], axis_name="map")
    out = {"shape": np.asarray(shape), "k": np.asarray(cs.SHARDED_GOLDEN_K)}
    for name in ORDER:
        kw = row_kwargs(name)
        t0 = time.perf_counter()
        smap, poses = MapShardedPointFusion(mesh=mesh, **kw)(frames)
        poses = np.asarray(poses)[0]
        counts = np.asarray(smap.num_points)[:, 0]
        feats = np.asarray(smap.features)[0, :, 0]
        C = feats.shape[0] // len(counts)
        mass = sum(float(feats[k * C:k * C + n].astype(np.float64).sum())
                   for k, n in enumerate(counts))
        out[f"{name}_poses"] = poses
        out[f"{name}_shard_counts"] = counts
        out[f"{name}_num_points"] = int(counts.sum())
        out[f"{name}_num_dropped"] = int(np.asarray(smap.num_dropped).sum())
        out[f"{name}_mass"] = mass
        out[f"{name}_ate_m"] = float(ate_rmse(poses, P[0]))
        out[f"{name}_config"] = json.dumps(kw, sort_keys=True)
        os.makedirs(os.path.dirname(OUT), exist_ok=True)
        np.savez(OUT, **out)
        print(f"{name}: {time.perf_counter() - t0:.1f} s, map {out[f'{name}_num_points']} "
              f"(shards {counts.tolist()}), dropped {out[f'{name}_num_dropped']}, mass "
              f"{mass:.6f}, aligned ATE {out[f'{name}_ate_m']:.4e} m", flush=True)
    print(f"-> {OUT}")


if __name__ == "__main__":
    main()
