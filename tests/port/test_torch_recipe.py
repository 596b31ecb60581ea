"""The production hard-clip recipe (``scripts/bench_all.py:606-612``) held
against the JAX package on the CPU, at the reference examples' 160x120 on a
9-frame hard clip, with the production option list at the same ratios
(``pyramid=[(2, 6), (2, 4)]``, ``normal_pitch=1``, ``map_capacity=4*H*W`` so
that ``'auto'`` fuses with the window on both sides, ``prune_every=4``).

Tolerances:

- frame by frame, each step started from the JAX state (the map and the
  prediction carried across): poses within 1e-4, equal map counts, map rows
  within 1e-5;
- the whole run: poses within 1e-4 up to frame 2 and within 5e-3 after, map
  counts within 0.2%, against the JAX package's whole run on the same clip
  in the committed golden ``tests/port/data/recipe_jax_cpu.npz`` (written
  by ``tests/port/make_recipe_golden.py``). The whole run cannot hold 1e-4 to the end: the gap
  first appears on frame 1, in the 1-NN level's 4th iteration, where one
  nearest-neighbour near-tie flips on a 1.8e-7 m difference of the source
  iterate (the JAX CPU backend fuses multiply-adds and orders its sums
  differently from torch). The clip's outliers and Tukey gates make the
  run chaotic, and the constant-velocity prediction carries each frame's
  gap into the next: measured 3.3e-5 m on frame 1, 6.9e-5 on frame 2,
  2.9e-4 on frame 3 and 2.3e-3 on frame 8, while every single step stays
  within 2.5e-5.
"""

import hashlib
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import gradslam_tpu as G  # noqa: E402
from gradslam_torch import PointFusion, hard_sequence  # noqa: E402
from gradslam_torch.geometry import orthonormalize_rotations  # noqa: E402
from gradslam_torch.interop import rgbdimages_from_numpy  # noqa: E402
from gradslam_torch.metrics import ate_rmse  # noqa: E402
from gradslam_tpu.slam.fusionutils import prune_map as jax_prune_map  # noqa: E402

from ._parity import jax_map_to_torch  # noqa: E402

L, H, W = 9, 120, 160
RECIPE = dict(
    odom="gradicp", pyramid=[(2, 6), (2, 4)], odom_assoc=["projective", "knn"],
    odom_sym_normals=True, odom_angle_gate=45.0, map_capacity=4 * H * W,
    prune_every=4, prune_min_confidence=1.5, quantize_colors=True,
    lookahead_assoc="reuse", motion_model="constant_velocity", robust_loss="tukey",
    robust_scale=0.03, dist_thresh=0.01, normal_pitch=1,
)


GOLDEN = Path(__file__).resolve().parent / "data" / "recipe_jax_cpu.npz"


def clip_sha256(clip) -> str:
    h = hashlib.sha256()
    for a in clip:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


@pytest.fixture(scope="module")
def clip():
    return hard_sequence(1, L, H, W)


def _jax_frame(clip, f, pose):
    rgb, depth, K, _ = clip
    return G.RGBDImages(jnp.asarray(rgb[:, f:f + 1]), jnp.asarray(depth[:, f:f + 1]),
                        jnp.asarray(K), jnp.asarray(pose)[:, None])


def test_recipe_each_frame_matches_jax(clip):
    rgb, depth, K, P = clip
    js, ts = G.PointFusion(**RECIPE), PointFusion(**RECIPE)
    jmap = js.map_update(js.empty_map(1, 4 * H * W), _jax_frame(clip, 0, P[:, 0]))
    prev, delta = P[:, 0].copy(), np.eye(4, dtype=np.float32)[None]
    for f in range(1, L):
        live = _jax_frame(clip, f, prev)
        jpose = np.array(js.localize(jmap, live, live, prev_transform=jnp.asarray(delta)))
        tmap = jax_map_to_torch(jmap)
        pred = orthonormalize_rotations(torch.from_numpy(delta) @ torch.from_numpy(prev))
        tlive = rgbdimages_from_numpy(rgb[:, f:f + 1], depth[:, f:f + 1], K,
                                      pred[:, None].numpy(), device="cpu")
        tpose = ts._localize(tmap, tlive, tlive)
        np.testing.assert_allclose(tpose.numpy(), jpose, atol=1e-4, rtol=0, err_msg=f"frame {f}")
        # fuse at the JAX pose on both sides
        jmap = js.map_update(jmap, _jax_frame(clip, f, jpose[:, 0]))
        tmap = ts._map(tmap, tlive.with_poses(torch.from_numpy(jpose)))
        if (f + 1) % RECIPE["prune_every"] == 0:
            jmap = jax_prune_map(jmap, RECIPE["prune_min_confidence"])
            tmap = ts._prune(tmap)
        ours = jax_map_to_torch(jmap)
        np.testing.assert_array_equal(tmap.num_points.numpy(), ours.num_points.numpy())
        np.testing.assert_allclose(tmap.points.numpy(), ours.points.numpy(), atol=1e-5, rtol=0)
        np.testing.assert_allclose(tmap.features[..., 0].numpy(), ours.features[..., 0].numpy(),
                                   atol=1e-5, rtol=0)
        delta = np.array(jnp.asarray(jpose[:, 0]) @ G.inverse_transformation(jnp.asarray(prev)))
        prev = jpose[:, 0]


def test_recipe_whole_run_matches_jax(clip):
    rgb, depth, K, P = clip
    golden = np.load(GOLDEN)  # the JAX package's run of this clip
    assert str(golden["clip_sha256"]) == clip_sha256(clip)
    tpc, tposes = PointFusion(**RECIPE)(rgbdimages_from_numpy(rgb, depth, K, P, device="cpu"))
    jposes, tposes = golden["poses"], tposes.numpy()
    assert tposes.shape == (1, L, 4, 4) and np.isfinite(tposes).all()
    gap = np.abs(tposes - jposes).reshape(L, 16).max(-1)
    assert (gap[:3] <= 1e-4).all(), gap
    assert (gap <= 5e-3).all(), gap
    n_j, n_t = int(golden["num_points"]), int(tpc.num_points[0])
    assert abs(n_t - n_j) <= 0.002 * n_j
    assert int(tpc.num_dropped[0]) == int(golden["num_dropped"]) == 0
    assert tpc.colors is None and tpc.features.shape[-1] == 2  # quantized layout
    assert tpc.capacity == 4 * H * W
    # both track the 6 cm/frame clip to within a few cm
    ate_t = float(ate_rmse(torch.from_numpy(tposes[0]), torch.from_numpy(P[0])))
    ate_j = float(golden["ate_m"])
    assert ate_t < 0.05 and abs(ate_t - ate_j) < 5e-3
