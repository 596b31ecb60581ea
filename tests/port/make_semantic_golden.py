"""Write the JAX package's CPU runs of the semantic slice, the golden that
``chip_smoke.py``'s ``semantic_online_phase`` holds the port's card runs
against.

The rows are ``chip_smoke.SEMANTIC_ROWS`` with ``feature_channels=SEM_F``
(21) on ``synthetic_sequence(1, 30, 480, 640, seed=0)`` (ICPSLAM's row on
its 320x240 clip), the user plane the 10 cm world-x stripes of
``chip_smoke.stripe_plane``. The file holds summaries only. For each row
``<name>``: ``<name>_num_points``, ``<name>_num_dropped``, the per-channel
sums of the user features over the map's rows (``<name>_feature_sums``,
float64), the histogram of their argmax classes (``<name>_class_hist``),
and for the tracked row its poses, aligned ATE and ``rpe`` (translation and
rotation RMSE, delta 1). For the K-NN check on frame 0's stride-4 cloud
(``chip_smoke.stride_cloud``, 19,200 points): a SHA-256 of the input
points, the neighbour indices of ``knn_points(K=17)`` as int16 offsets from
each row's own index (``knn_idx_delta``), and the ``estimate_normals(k=16)``
normals of every 4th row. ``rows_json`` and ``consts_json`` record the
rows and constants the golden was made from. Regenerate it from the root of
the repo with

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/port/make_semantic_golden.py

(about 5 minutes and a few GB of memory on the CPU).
"""

import hashlib
import json
import os
import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import chip_smoke as cs  # noqa: E402
import gradslam_tpu as G  # noqa: E402
from gradslam_tpu.datasets import synthetic_sequence  # noqa: E402
from gradslam_tpu.metrics import ate_rmse, rpe  # noqa: E402
from gradslam_tpu.ops.knn import knn_points  # noqa: E402
from gradslam_tpu.structures.utils import estimate_normals  # noqa: E402

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "semantic_jax_cpu.npz")


def consts() -> dict:
    """The constants of ``chip_smoke.py`` that the golden's numbers depend on."""
    return {"SEM_F": cs.SEM_F, "SEM_STRIPE_M": cs.SEM_STRIPE_M, "KNN_K": cs.KNN_K,
            "KNN_STRIDE": cs.KNN_STRIDE, "KNN_GOLDEN_NORMAL_ROWS": cs.KNN_GOLDEN_NORMAL_ROWS}


def feature_base(cls: str, kw: dict) -> int:
    """Bookkeeping channels before the user ones: ``[ccount]`` or
    ``[ccount, packed_color]`` (PointFusion), ``[alpha]`` (ICPSLAM)."""
    return 2 if cls == "PointFusion" and kw.get("quantize_colors") else 1


def run_row(out: dict, name: str) -> None:
    cls, shape, kw = cs.SEMANTIC_ROWS[name]
    rgb, depth, K, P = synthetic_sequence(*shape, seed=0)
    plane = cs.stripe_plane(depth, K, P)
    frames = G.RGBDImages(jnp.asarray(rgb), jnp.asarray(depth), jnp.asarray(K), jnp.asarray(P),
                          feature_image=jnp.asarray(plane))
    t0 = time.perf_counter()
    pc, poses = getattr(G, cls)(feature_channels=cs.SEM_F, **kw)(frames)
    n = int(pc.num_points[0])
    user = np.asarray(pc.features[0, :n, feature_base(cls, kw):])
    out[f"{name}_num_points"] = n
    out[f"{name}_num_dropped"] = int(pc.num_dropped[0])
    out[f"{name}_feature_sums"] = user.astype(np.float64).sum(0)
    out[f"{name}_class_hist"] = np.bincount(user.argmax(1), minlength=cs.SEM_F)
    line = f"{name}: {time.perf_counter() - t0:.1f} s, map {n}"
    if kw["odom"] != "gt":
        poses = np.asarray(poses)[0]
        trans, rot = rpe(jnp.asarray(poses), jnp.asarray(P[0]))
        out[f"{name}_poses"] = poses
        out[f"{name}_ate_m"] = float(ate_rmse(poses, P[0]))
        out[f"{name}_rpe"] = np.array([float(trans), float(rot)])
        line += f", aligned ATE {out[f'{name}_ate_m']:.4e} m, rpe {out[f'{name}_rpe']}"
    print(line, flush=True)


def knn_rows(out: dict) -> None:
    _, depth, K, P = synthetic_sequence(*cs.SEMANTIC_ROWS["gt"][1], seed=0)
    pts = cs.stride_cloud(depth, K, P)
    t0 = time.perf_counter()
    idx = np.asarray(knn_points(jnp.asarray(pts), jnp.asarray(pts), K=cs.KNN_K).idx)[0]
    delta = idx.astype(np.int64) - np.arange(idx.shape[0])[:, None]
    assert np.abs(delta).max() < 2**15, "neighbour offsets do not fit int16"
    pc = G.Pointclouds(points=jnp.asarray(pts), num_points=jnp.asarray([pts.shape[1]]))
    normals = np.asarray(estimate_normals(pc, k=cs.KNN_K - 1).normals)[0]
    out["knn_input_sha256"] = hashlib.sha256(pts.tobytes()).hexdigest()
    out["knn_idx_delta"] = delta.astype(np.int16)
    out["knn_normals"] = normals[::cs.KNN_GOLDEN_NORMAL_ROWS]
    print(f"knn: {time.perf_counter() - t0:.1f} s, {pts.shape[1]} points", flush=True)


def main():
    out = {"rows_json": json.dumps(cs.SEMANTIC_ROWS), "consts_json": json.dumps(consts())}
    knn_rows(out)
    for name in cs.SEMANTIC_ROWS:
        run_row(out, name)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez_compressed(OUT, **out)
    print(f"-> {OUT} ({os.path.getsize(OUT)} bytes)")


if __name__ == "__main__":
    main()
