"""The port's relocalization (``gradslam_torch/slam/relocalize.py``) held
against the JAX package on the CPU: the map of a 6-frame 60x80 synthetic
clip (``odom='gt'`` in JAX, carried across) and the last frame kidnapped by
0.3 m and 15 degrees, camera-local, as in ``tests/slam/test_relocalize.py``.
The clip is the easy one: on the JAX test's noisy hard clip the solves
amplify rounding (JAX's own two hypothesis modes part by about 3e-4 there,
``tests/slam/test_relocalize.py:208``), so it cannot hold a 1e-5 bar.

Tolerances: ``perturbation_grid`` within 1e-7 and one float32 ulp of each
element (``se3_exp`` rounds the deltas' trigonometry by an ulp in places);
solved poses |dT| <= 1e-5 with the same winner; scores within 1/N (N the
frame cloud's rows); the port's two hypothesis modes give the same poses
within 1e-6 and the same scores."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import gradslam_tpu as G  # noqa: E402
import gradslam_torch as T  # noqa: E402
from gradslam_torch.odometry.icputils import downsample_rgbdimages  # noqa: E402

from ._parity import both_frames, jax_map_to_torch, rigid_transforms  # noqa: E402


from ._threads import one_thread  # noqa: E402,F401


@pytest.fixture(scope="module")
def tracked_run():
    """The last frame of the clip in both packages, the map of all six
    frames in both, and the last frame's pose."""
    B, L, H, W = 1, 6, 60, 80
    rgb, d, K, poses = T.synthetic_sequence(B, L, H, W, speed=4.0)
    jf, tf = both_frames(rgb, d, K, poses)
    pc, op = G.PointFusion(odom="gt", map_capacity=L * H * W)(jf)
    return jf[:, L - 1], tf[:, L - 1], pc, jax_map_to_torch(pc), np.array(op)[:, L - 1]


def kidnap(pose, dx=0.3, yaw_deg=15.0):
    """A kidnap as in the JAX test: a camera-local translation and yaw."""
    xi = jnp.asarray([dx, 0.0, 0.0, 0.0, np.radians(yaw_deg), 0.0], jnp.float32)
    return np.array(jnp.einsum("bij,jk->bik", jnp.asarray(pose), G.se3_exp(xi)))


GRID = dict(yaw_deg=(0.0, -15.0, 15.0), translations=((0, 0, 0), (-0.3, 0, 0)))


@pytest.mark.parametrize("grid", [
    {},
    GRID,
    dict(yaw_deg=(30.0,), translations=((0.1, -0.2, 0.3), (0, 0, 0.2))),
], ids=["defaults", "yaw3_x2", "offsets"])
def test_perturbation_grid_matches_jax(grid):
    poses = rigid_transforms(np.random.RandomState(0), 3)
    ours = T.perturbation_grid(torch.from_numpy(poses), **grid)
    theirs = G.slam.perturbation_grid(jnp.asarray(poses), **grid)
    assert tuple(ours.shape) == tuple(theirs.shape)
    ulp = np.spacing(np.abs(np.asarray(theirs)))
    assert (np.abs(ours.numpy() - np.asarray(theirs)) <= 1e-7 + ulp).all()
    if not grid.get("yaw_deg", (0.0,))[0] and not any(grid.get("translations", ((0,),))[0]):
        np.testing.assert_allclose(ours[:, 0].numpy(), poses, atol=1e-7, rtol=0)


@pytest.mark.parametrize("odom", ["gradicp", "icp"])
def test_relocalize_matches_jax(tracked_run, odom):
    live_j, live_t, jpc, tpc, solved = tracked_run
    bad = kidnap(solved)
    anchors = np.asarray(G.slam.perturbation_grid(jnp.asarray(bad), **GRID))
    kw = dict(odom=odom, dsratio=4, numiters=8, robust_scale=0.03)
    p_t, i_t = T.relocalize(tpc, live_t, torch.from_numpy(anchors.copy()), **kw)
    p_j, i_j = G.slam.relocalize(jpc, live_j, jnp.asarray(anchors), **kw)
    assert tuple(p_t.shape) == (1, 1, 4, 4)
    assert int(i_t["best_hypothesis"][0]) == int(i_j["best_hypothesis"][0])
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), atol=1e-5, rtol=0)
    n_rows = int(downsample_rgbdimages(live_t, 4).num_points[0])
    np.testing.assert_allclose(i_t["hypothesis_inlier_frac"].numpy(),
                               np.asarray(i_j["hypothesis_inlier_frac"]),
                               atol=1.0 / n_rows + 1e-7, rtol=0)
    assert float(i_t["inlier_frac"][0]) == float(i_t["hypothesis_inlier_frac"].max())
    # the kidnap is undone: within 2 cm of the solved pose
    assert float(np.linalg.norm(p_t.numpy()[0, 0, :3, 3] - solved[0, :3, 3])) < 0.02


def test_scan_equals_vmap(tracked_run):
    """The K hypotheses folded into the batch (one 1-NN launch an
    iteration for all of them) and solved one after another: the same
    solved poses and scores, so the same winner."""
    _, live_t, _, tpc, solved = tracked_run
    anchors = T.perturbation_grid(torch.from_numpy(kidnap(solved)), **GRID)
    out = {m: T.relocalize(tpc, live_t, anchors, dsratio=4, numiters=8, robust_scale=0.03,
                           hypothesis_mode=m) for m in ("vmap", "scan")}
    (p_v, i_v), (p_s, i_s) = out["vmap"], out["scan"]
    assert torch.equal(i_v["best_hypothesis"], i_s["best_hypothesis"])
    np.testing.assert_allclose(p_v.numpy(), p_s.numpy(), atol=1e-6, rtol=0)
    np.testing.assert_allclose(i_v["hypothesis_inlier_frac"].numpy(),
                               i_s["hypothesis_inlier_frac"].numpy(), atol=1e-7, rtol=0)


def test_vmap_keeps_hypothesis_order_per_sequence(tracked_run):
    """B=2 with different hypotheses per sequence: the (B, K) -> B*K fold
    keeps each sequence's hypotheses together and in order, and each
    sequence's result equals its own B=1 call."""
    _, live_t, _, tpc, solved = tracked_run
    two = lambda x: torch.cat([x, x])  # noqa: E731
    pc2 = T.Pointclouds(points=two(tpc.points), num_points=two(tpc.num_points),
                        normals=two(tpc.normals))
    live2 = dataclasses.replace(live_t, rgb_image=two(live_t.rgb_image),
                                depth_image=two(live_t.depth_image),
                                intrinsics=two(live_t.intrinsics), poses=None)
    grids = [T.perturbation_grid(torch.from_numpy(kidnap(solved, dx=dx)), **GRID)
             for dx in (0.3, -0.1)]
    p2, i2 = T.relocalize(pc2, live2, torch.cat(grids), dsratio=4, numiters=8,
                          robust_scale=0.03)
    for b in range(2):
        p1, i1 = T.relocalize(tpc, live_t, grids[b], dsratio=4, numiters=8, robust_scale=0.03)
        assert int(i2["best_hypothesis"][b]) == int(i1["best_hypothesis"][0])
        np.testing.assert_allclose(p2[b].numpy(), p1[0].numpy(), atol=1e-6, rtol=0)


def test_argmax_takes_the_first_maximum():
    """Two hypotheses that are the same pose score the same: the first
    wins, as with ``jnp.argmax``."""
    scores = torch.tensor([[0.2, 0.7, 0.7, 0.1]])
    assert int(torch.argmax(scores, dim=1)[0]) == int(jnp.argmax(jnp.asarray(scores.numpy()),
                                                                 axis=1)[0]) == 1


def test_empty_view_scores_zero(tracked_run):
    """A hypothesis whose frustum holds no map point scores 0 (JAX's own
    test holds the same for the JAX package): the 1-NN's no-target sentinel
    (1e30, 0) is not admissible."""
    _, live_t, _, tpc, solved = tracked_run
    gone = solved.copy()
    gone[:, 0, 3] += 100.0
    _, info = T.relocalize(tpc, live_t, torch.from_numpy(gone)[:, None], dsratio=4,
                           numiters=2, robust_scale=0.03)
    assert float(info["inlier_frac"][0]) == 0.0


@pytest.mark.parametrize("case", [
    "map_type", "frame_type", "anchor_shape", "odom", "no_normals", "mode",
    "grid_pose_shape", "grid_empty", "grid_translation",
])
def test_validation_matches_jax(tracked_run, case):
    live_j, live_t, jpc, tpc, solved = tracked_run
    a_t, a_j = torch.from_numpy(solved)[:, None], jnp.asarray(solved)[:, None]
    calls = {
        "map_type": (lambda: T.relocalize(live_t, live_t, a_t),
                     lambda: G.slam.relocalize(live_j, live_j, a_j)),
        "frame_type": (lambda: T.relocalize(tpc, tpc, a_t),
                       lambda: G.slam.relocalize(jpc, jpc, a_j)),
        "anchor_shape": (lambda: T.relocalize(tpc, live_t, a_t[:, 0]),
                         lambda: G.slam.relocalize(jpc, live_j, a_j[:, 0])),
        "odom": (lambda: T.relocalize(tpc, live_t, a_t, odom="gt"),
                 lambda: G.slam.relocalize(jpc, live_j, a_j, odom="gt")),
        "no_normals": (lambda: T.relocalize(dataclasses.replace(tpc, normals=None), live_t, a_t),
                       lambda: G.slam.relocalize(dataclasses.replace(jpc, normals=None),
                                                 live_j, a_j)),
        "mode": (lambda: T.relocalize(tpc, live_t, a_t, hypothesis_mode="parallel"),
                 lambda: G.slam.relocalize(jpc, live_j, a_j, hypothesis_mode="parallel")),
        "grid_pose_shape": (lambda: T.perturbation_grid(torch.eye(4)),
                            lambda: G.slam.perturbation_grid(jnp.eye(4))),
        "grid_empty": (lambda: T.perturbation_grid(torch.eye(4)[None], yaw_deg=()),
                       lambda: G.slam.perturbation_grid(jnp.eye(4)[None], yaw_deg=())),
        "grid_translation": (
            lambda: T.perturbation_grid(torch.eye(4)[None], translations=((0, 0),)),
            lambda: G.slam.perturbation_grid(jnp.eye(4)[None], translations=((0, 0),))),
    }[case]
    errors = []
    for call in calls:
        with pytest.raises((TypeError, ValueError)) as e:
            call()
        errors.append(e.value)
    assert type(errors[0]) is type(errors[1])
    if case not in ("map_type", "frame_type", "anchor_shape", "grid_pose_shape"):
        assert str(errors[0]) == str(errors[1])  # shapes print as tuples in the port
