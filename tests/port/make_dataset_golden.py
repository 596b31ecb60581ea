"""Write the JAX package's CPU runs of the dataset slice, the golden that
``chip_smoke.py``'s dataset phase holds the port's card runs against.

The trees are ``chip_smoke.py``'s: a TUM sequence and an ICL trajectory of
``DS_L`` frames at 640x480 (``dataset_clip`` at TUM's and at ICL's
intrinsics, written by ``write_tum_tree`` and ``write_icl_tree``; PNG is
lossless, so which encoder wrote them does not matter). The JAX package's
own loaders read them, and its pipelines run as its example CLIs build
them:

- ``tum``: ``examples/pointfusion.py --dataset tum`` with
  ``chip_smoke.DS_POINTFUSION_ARGS`` (gradICP at 640x480x30, the default map
  capacity L * H * W = 9,216,000 rows, fusion modes ``'auto'``);
- ``icl``: ``examples/icpslam.py --dataset icl`` with
  ``chip_smoke.DS_ICPSLAM_ARGS`` (ICP at 320x240x30, the loader resizing
  the 640x480 files).

For each the file holds the poses (``<name>_poses``), the map count
(``<name>_num_points``), ``<name>_num_dropped``, the unaligned translation
RMSE against the clip's poses (``<name>_ate_unaligned_m``) and the
Umeyama-aligned ATE (``<name>_ate_m``). It also checks that the JAX TUM
loader's sample equals ``chip_smoke.decoded_arrays`` bit for bit, the
arrays that the card's in-memory run starts from. Regenerate it from the
root of the repo with

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/port/make_dataset_golden.py

(a few GB of memory on the CPU).
"""

import os
import sys
import tempfile
import time
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import chip_smoke as cs  # noqa: E402
from gradslam_tpu import ICPSLAM, PointFusion, RGBDImages  # noqa: E402
from gradslam_tpu.datasets import ICL, TUM  # noqa: E402
from gradslam_tpu.metrics import ate_rmse  # noqa: E402

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "dataset_jax_cpu.npz")

# examples/icpslam.py's ICPSLAM arguments at its flag defaults
ICPSLAM_CLI_DEFAULTS = dict(odom_assoc="knn", odom_sym_normals=False, odom_point_weight=0.0,
                            odom_subpixel=False, icp_window_frames=None)


def flag(args: list, name: str) -> str:
    return args[args.index(name) + 1]


def frames_of(sample) -> RGBDImages:
    colors, depths, intrinsics, poses = sample[:4]
    return RGBDImages(jnp.asarray(colors)[None], jnp.asarray(depths)[None],
                      jnp.asarray(intrinsics)[None, None], jnp.asarray(poses)[None])


def record(out: dict, name: str, pc, poses, gt: np.ndarray, secs: float) -> None:
    poses = np.asarray(poses)[0]
    err = poses[:, :3, 3].astype(np.float64) - gt[:, :3, 3].astype(np.float64)
    out[f"{name}_poses"] = poses
    out[f"{name}_num_points"] = int(pc.num_points[0])
    out[f"{name}_num_dropped"] = int(pc.num_dropped[0]) if pc.num_dropped is not None else 0
    out[f"{name}_ate_m"] = float(ate_rmse(poses, gt))
    out[f"{name}_ate_unaligned_m"] = float(np.sqrt(np.mean(np.sum(err**2, axis=-1))))
    print(f"{name}: {secs:.1f} s, map {out[f'{name}_num_points']}, dropped "
          f"{out[f'{name}_num_dropped']}, aligned ATE {out[f'{name}_ate_m']:.4e} m, "
          f"unaligned {out[f'{name}_ate_unaligned_m']:.4e} m", flush=True)


def main():
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        clip = cs.dataset_clip(cs.TUM_INTRINSICS)
        root = cs.write_tum_tree(tmp / "tum", clip)
        args = cs.DS_POINTFUSION_ARGS
        H, W, L = int(flag(args, "--height")), int(flag(args, "--width")), int(flag(args, "--seqlen"))
        sample = TUM(str(root), seqlen=L, height=H, width=W)[0]
        wants = [a[0] for a in cs.decoded_arrays(clip, cs.TUM_INTRINSICS)]
        wants[2] = wants[2][0]  # the intrinsics: (4, 4) in a sample
        for got, want in zip(sample[:4], wants):
            if not (got.dtype == want.dtype and np.array_equal(got, want)):
                raise AssertionError("the JAX TUM loader's sample differs from decoded_arrays")
        t0 = time.perf_counter()
        pc, poses = jax.block_until_ready(PointFusion(
            odom=flag(args, "--odometry"), **cs.DS_POINTFUSION_DEFAULTS)(frames_of(sample)))
        record(out, "tum", pc, poses, clip[2], time.perf_counter() - t0)

        clip = cs.dataset_clip(cs.ICL_INTRINSICS)
        root = cs.write_icl_tree(tmp / "icl", clip)
        args = cs.DS_ICPSLAM_ARGS
        H, W, L = int(flag(args, "--height")), int(flag(args, "--width")), int(flag(args, "--seqlen"))
        sample = ICL(str(root), seqlen=L, height=H, width=W)[0]
        t0 = time.perf_counter()
        pc, poses = jax.block_until_ready(ICPSLAM(
            odom=flag(args, "--odometry"), **ICPSLAM_CLI_DEFAULTS)(frames_of(sample)))
        record(out, "icl", pc, poses, clip[2], time.perf_counter() - t0)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez(OUT, **out)
    print(f"-> {OUT}")


if __name__ == "__main__":
    main()
