"""The port's projective odometry (gradLM and classic LM solvers) held
against the JAX package on the CPU: a map window from frame 0 of the
reference test clip, associated with frame 1 seen from a nudged pose.

Tolerances: associated points and normals within 1e-5 with equal validity
masks; solver corrections within |dT| <= 1e-5 (the bar ``PARITY.md`` sets
for solver transforms)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import gradslam_tpu as G  # noqa: E402
from gradslam_torch.odometry import ProjectiveOdometryProvider  # noqa: E402
from gradslam_torch.odometry import projective as P  # noqa: E402
from gradslam_tpu.odometry import icputils as JI  # noqa: E402
from gradslam_tpu.odometry import projective as JP  # noqa: E402

from ._parity import both_frames, jax_map_to_torch, msrd  # noqa: E402

ATOL_T = 1e-5


@pytest.fixture(scope="module")
def scene():
    """Map window (ds 4) of frame 0, and frame 1 at its pose nudged by
    about 1 cm and 0.6 degrees, as JAX and torch structures."""
    m = msrd()
    jf, _ = both_frames(m["colors"], m["depths"], m["intrinsics"], m["poses"])
    win = JI.downsample_rgbdimages(jf[:, 0], 4)
    win = G.Pointclouds(points=win.points, num_points=win.num_points, normals=win.normals)
    nudge = np.asarray(G.se3_exp(jnp.asarray([0.006, -0.004, 0.008, 0.01, -0.004, 0.006])))
    pose = m["poses"][:, 1:2] @ nudge
    live_j, live_t = both_frames(m["colors"][:, 1:2], m["depths"][:, 1:2], m["intrinsics"], pose)
    return win, live_j, live_t


def _frame_geom_jax(live_j):
    B, _, H, W = live_j.shape
    vert = live_j.vertex_map.reshape(B, H * W, 3)
    nrm = live_j.normal_map.reshape(B, H * W, 3)
    valid = live_j.valid_depth_mask.reshape(B, H * W, 1).astype(vert.dtype)
    return jnp.concatenate([vert, nrm, valid, jnp.zeros_like(valid)], axis=-1)


def test_frame_geom_matches_jax(scene):
    _, live_j, live_t = scene
    np.testing.assert_allclose(P.pack_frame_geom(live_t).numpy(),
                               np.asarray(_frame_geom_jax(live_j)), atol=1e-6, rtol=0)


@pytest.mark.parametrize("dist_thresh, dot_gate", [(None, None), (0.01, None), (0.01, 0.7071)])
def test_projective_associate_matches_jax(scene, dist_thresh, dot_gate):
    win, live_j, live_t = scene
    twin = jax_map_to_torch(win)
    _, _, H, W = live_t.shape
    s, valid, n = P.projective_associate(
        twin.points, twin.normals, twin.nonpad_mask, P.pack_frame_geom(live_t),
        live_t.intrinsics[:, 0], live_t.poses[:, 0], H, W, dist_thresh, dot_gate)
    fg = _frame_geom_jax(live_j)
    for b in range(2):
        js, jv, jn = JP.projective_associate(
            win.points[b], win.normals[b], win.nonpad_mask[b], fg[b],
            live_j.intrinsics[b, 0], live_j.poses[b, 0], H, W, dist_thresh, dot_gate)
        np.testing.assert_array_equal(valid[b].numpy(), np.asarray(jv))
        assert 0 < int(valid[b].sum()) < valid.shape[1]
        np.testing.assert_allclose(s[b].numpy(), np.asarray(js), atol=1e-5, rtol=0)
        np.testing.assert_allclose(n[b].numpy(), np.asarray(jn), atol=1e-5, rtol=0)


@pytest.mark.parametrize("sym_normals", [False, True], ids=["map_normals", "sym_normals"])
@pytest.mark.parametrize("lookahead, loss, gate", [
    ("fresh", None, None),
    ("reuse", "tukey", 0.7071),
    ("fresh", "huber", None),
])
def test_projective_gradicp_matches_jax(scene, sym_normals, lookahead, loss, gate):
    win, live_j, live_t = scene
    twin = jax_map_to_torch(win)
    _, _, H, W = live_t.shape
    rng = np.random.RandomState(8)
    init = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    init[:, :3, 3] = 0.003 * rng.randn(2, 3)
    kw = dict(numiters=5, dist_thresh=0.01, dot_gate=gate, lookahead_assoc=lookahead,
              robust_loss=loss, robust_scale=0.03, sym_normals=sym_normals)
    ours = P.point_to_plane_gradICP_projective(
        twin.points, twin.normals, twin.nonpad_mask, P.pack_frame_geom(live_t),
        live_t.intrinsics[:, 0], live_t.poses[:, 0], H, W,
        initial_transform=torch.from_numpy(init), **kw)
    fg = _frame_geom_jax(live_j)
    for b in range(2):
        theirs = JP.point_to_plane_gradICP_projective(
            win.points[b], win.normals[b], win.nonpad_mask[b], fg[b],
            live_j.intrinsics[b, 0], live_j.poses[b, 0], H, W,
            initial_transform=jnp.asarray(init[b]), **kw)
        np.testing.assert_allclose(ours[b].numpy(), np.asarray(theirs), atol=ATOL_T, rtol=0)
    assert torch.isfinite(ours).all()
    # the solve moved the pose
    assert float((ours - torch.from_numpy(init)).abs().max()) > 1e-4


@pytest.mark.parametrize("lookahead, loss, gate, sym_normals", [
    ("fresh", None, None, False),
    ("reuse", "tukey", 0.7071, True),
    ("fresh", "huber", None, True),
])
def test_projective_lm_icp_matches_jax(scene, lookahead, loss, gate, sym_normals):
    """The classic LM solver (``solver='icp'``): accept/reject steps."""
    win, live_j, live_t = scene
    twin = jax_map_to_torch(win)
    _, _, H, W = live_t.shape
    rng = np.random.RandomState(9)
    init = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    init[:, :3, 3] = 0.003 * rng.randn(2, 3)
    kw = dict(numiters=5, dist_thresh=0.01, dot_gate=gate, lookahead_assoc=lookahead,
              robust_loss=loss, robust_scale=0.03, sym_normals=sym_normals)
    ours = P.point_to_plane_ICP_projective(
        twin.points, twin.normals, twin.nonpad_mask, P.pack_frame_geom(live_t),
        live_t.intrinsics[:, 0], live_t.poses[:, 0], H, W,
        initial_transform=torch.from_numpy(init), **kw)
    fg = _frame_geom_jax(live_j)
    for b in range(2):
        theirs = JP.point_to_plane_ICP_projective(
            win.points[b], win.normals[b], win.nonpad_mask[b], fg[b],
            live_j.intrinsics[b, 0], live_j.poses[b, 0], H, W,
            initial_transform=jnp.asarray(init[b]), **kw)
        np.testing.assert_allclose(ours[b].numpy(), np.asarray(theirs), atol=ATOL_T, rtol=0)
    assert torch.isfinite(ours).all()
    assert float((ours - torch.from_numpy(init)).abs().max()) > 1e-4


def test_provider_matches_jax(scene):
    win, live_j, live_t = scene
    kw = dict(numiters=4, dist_thresh=0.01, dot_gate=0.7071, lookahead_assoc="reuse",
              robust_loss="tukey", robust_scale=0.03, sym_normals=True)
    theirs = JP.ProjectiveOdometryProvider(**kw).provide(win, live_j)
    ours = ProjectiveOdometryProvider(**kw).provide(jax_map_to_torch(win), live_t)
    assert ours.shape == (2, 1, 4, 4)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=ATOL_T, rtol=0)


def test_lm_provider_matches_jax(scene):
    win, live_j, live_t = scene
    kw = dict(solver="icp", numiters=4, dist_thresh=0.01, dot_gate=0.7071,
              lookahead_assoc="reuse", robust_loss="tukey", robust_scale=0.03, sym_normals=True)
    theirs = JP.ProjectiveOdometryProvider(**kw).provide(win, live_j)
    ours = ProjectiveOdometryProvider(**kw).provide(jax_map_to_torch(win), live_t)
    assert ours.shape == (2, 1, 4, 4)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=ATOL_T, rtol=0)
    with pytest.raises(ValueError, match="solver"):
        ProjectiveOdometryProvider(solver="bogus")


@pytest.mark.parametrize("kw, item", [
    ({"point_weight": 0.25}, "item 6"),
    ({"subpixel": True}, "item 6"),
])
def test_unported_provider_options_raise(kw, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md queue 1, {item}"):
        ProjectiveOdometryProvider(**kw)
