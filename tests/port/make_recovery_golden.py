"""Write the JAX package's CPU runs of the recovery, sub-pixel and point-row
rows, the golden that ``chip_smoke.py`` holds the port's card runs against.

The rows come from ``chip_smoke.py``:

- ``kidnap_<name>`` for ``name`` in ``kidnap_rows``: the kidnapped clip
  (``kidnap_clip``, ``tests/slam/test_inscan_relocalize.py:20-40`` at
  ``KIDNAP_SHAPE``) through ``PointFusion(**KIDNAP_BASE, ...)`` armed with the
  1-NN or the projective tracker, and unarmed;
- ``drift_<name>`` for ``DRIFT_ROWS``: the drift clip of
  ``tests/slam/test_anchor_recover.py:44-72``, plain and anchored;
- ``subpixel_<name>`` for ``SUBPIXEL_ROWS`` on the easy
  ``synthetic_sequence(1, 30, 480, 640)`` clip with ``SCHEDULE``;
- ``hard_subpixel``: ``HARD_SUBPIXEL`` (``scripts/bench_all.py:553-563``) on
  ``hard_sequence(1, 30, 480, 640)``.

For each row the file holds the poses (``<row>_poses``), the final map count
(``<row>_num_points``), ``<row>_num_dropped``, the Umeyama-aligned ATE
(``<row>_ate_m``), the unaligned translation RMSE (``<row>_ate_unaligned_m``)
and, for the kidnap rows, the unaligned translation RMSE over frames 8-10
(``<row>_post_ate_m``), the in-scan health gate's inlier fraction of each
tracked frame (``<row>_health``, ``(L - 1,)``; empty for the unarmed row),
read through a ``jax.debug.callback`` on ``ICPSLAM._health_gate``, and
whether the drift gate flagged the sequence on each tracked frame
(``<row>_drift``, ``(L - 1,)`` bool, read through a callback on
``ICPSLAM._maybe_anchor_recover``, which runs on the pose the relocalization
returns; empty for the rows without the anchor). Regenerate it from the root
of the repo with

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/port/make_recovery_golden.py

(about 10 minutes and a few GB of memory on the CPU). Given row names (for
example ``kidnap_knn_anchor``), it runs those rows only and writes them into
the existing file, whose other rows it keeps.
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
from gradslam_tpu.datasets import hard_sequence, synthetic_sequence  # noqa: E402
from gradslam_tpu.metrics import ate_rmse  # noqa: E402
from gradslam_tpu.slam.icpslam import ICPSLAM  # noqa: E402

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "recovery_jax_cpu.npz")

HEALTH = []  # the health gate's readings of the current run, in frame order
DRIFT = []  # the drift gate's flags of the current run, in frame order


def _record_health():
    gate = ICPSLAM._health_gate

    def recorded(self, live, poses, window):
        inlier = gate(self, live, poses, window)
        jax.debug.callback(lambda x: HEALTH.append(np.asarray(x)), inlier, ordered=True)
        return inlier

    ICPSLAM._health_gate = recorded
    anchor_recover = ICPSLAM._maybe_anchor_recover

    def drift_recorded(self, anchor, live, poses):
        poses, drifting = anchor_recover(self, anchor, live, poses)
        jax.debug.callback(lambda x: DRIFT.append(np.asarray(x)), drifting, ordered=True)
        return poses, drifting

    ICPSLAM._maybe_anchor_recover = drift_recorded


def run_row(out: dict, name: str, arrays, **kw) -> np.ndarray:
    """One run; its poses, map count and errors go into ``out``."""
    rgb, depth, K, P = arrays
    frames = RGBDImages(jnp.asarray(rgb), jnp.asarray(depth), jnp.asarray(K), jnp.asarray(P))
    HEALTH.clear()
    DRIFT.clear()
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
    return err


def main(only=()):
    """Every row, or only the rows named in ``only`` (merged into the
    existing file)."""
    _record_health()
    out = dict(np.load(OUT)) if only else {}

    def wanted(row):
        return not only or row in only

    rgb, depth, K, P, jump = cs.kidnap_clip()
    _, _, H, W = cs.KIDNAP_SHAPE
    L = len(cs.KIDNAP_ORDER)
    out["kidnap_jump"] = np.asarray(jump, np.float64)
    for name, kw in cs.kidnap_rows(jump).items():
        if not wanted(f"kidnap_{name}"):
            continue
        err = run_row(out, f"kidnap_{name}", (rgb, depth, K, P),
                      map_capacity=L * H * W, **cs.KIDNAP_BASE, **kw)
        post = float(np.sqrt(np.mean(np.sum(err[8:] ** 2, axis=-1))))
        out[f"kidnap_{name}_post_ate_m"] = post
        health = np.asarray(HEALTH, np.float32).reshape(-1)
        out[f"kidnap_{name}_health"] = health
        out[f"kidnap_{name}_drift"] = np.asarray(DRIFT, bool).reshape(-1)
        print(f"  post-kidnap unaligned RMSE {post:.4e} m, health " + " ".join(
            f"{h:.3f}" for h in health) + ", drifting at frames "
            f"{[f + 1 for f, d in enumerate(out[f'kidnap_{name}_drift']) if d]}", flush=True)

    B_, L_, H_, W_ = cs.DRIFT_SHAPE
    drift = hard_sequence(B_, L_, H_, W_, outlier_frac=0.0)
    for name, kw in cs.DRIFT_ROWS.items():
        if wanted(f"drift_{name}"):
            run_row(out, f"drift_{name}", drift, map_capacity=L_ * H_ * W_, **cs.DRIFT_BASE,
                    **kw)

    easy = synthetic_sequence(cs.B, cs.L, cs.H, cs.W, seed=0)
    for name, kw in cs.SUBPIXEL_ROWS.items():
        if wanted(f"subpixel_{name}"):
            run_row(out, f"subpixel_{name}", easy, **kw)
    if wanted("hard_subpixel"):
        run_row(out, "hard_subpixel", hard_sequence(cs.B, cs.L, cs.H, cs.W), **cs.HARD_SUBPIXEL)

    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez(OUT, **out)
    print(f"-> {OUT}")


if __name__ == "__main__":
    main(tuple(sys.argv[1:]))
