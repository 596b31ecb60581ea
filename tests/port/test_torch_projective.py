"""The port's projective odometry (gradLM and classic LM solvers) held
against the JAX package on the CPU: a map window from frame 0 of the
reference test clip, associated with frame 1 seen from a nudged pose.

Tolerances: associated points and normals within 1e-5 with equal validity
masks; solver corrections within |dT| <= 1e-5 (the bar ``PARITY.md`` sets
for solver transforms). Sub-pixel association: equal validity masks,
points within 1e-5 and 99% of the valid rows within 1e-6, normals within
5e-5: the bilinear weights come from the projected ``(u, v)``, which the
two frameworks round in another order (the camera transform's sums), and
renormalising a blend of unlike normals divides by a short vector
(measured: points 2.9e-6 at one of 869 rows, normals 1.5e-5). Sub-pixel
gradICP gradients against ``jax.grad``: 1e-3 of the largest, the bar of the
other tracked pipelines (``test_torch_grad_tracked.py``; measured 2.0e-4:
the bilinear weights' derivative jumps where ``u`` or ``v`` crosses a
pixel, and one ulp decides the side)."""

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

from . import _gradparity as GP  # noqa: E402
from ._parity import both_frames, jax_map_to_torch, msrd  # noqa: E402


from ._threads import one_thread  # noqa: E402,F401


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


@pytest.mark.parametrize("kw, error, match", [
    ({"point_weight": 0.25}, None, None),
    ({"subpixel": True}, None, None),
    ({"point_weight": 0.25, "subpixel": True, "solver": "icp"}, None, None),
    ({"point_weight": -0.5}, ValueError, "point_weight must be >= 0"),
], ids=["point_weight", "subpixel", "both_lm", "negative_point_weight"])
def test_provider_options_match_jax(kw, error, match):
    """The provider takes ``point_weight`` and ``subpixel`` as the JAX
    provider does, and refuses a negative weight with its error
    (``gradslam_tpu/odometry/projective.py:527``)."""
    if error is None:
        ours, theirs = ProjectiveOdometryProvider(**kw), JP.ProjectiveOdometryProvider(**kw)
        assert (ours.point_weight, ours.subpixel) == (theirs.point_weight, theirs.subpixel)
        return
    with pytest.raises(error, match=match) as ours:
        ProjectiveOdometryProvider(**kw)
    with pytest.raises(error, match=match) as theirs:
        JP.ProjectiveOdometryProvider(**kw)
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("dist_thresh, dot_gate", [(None, None), (0.01, 0.7071)])
def test_subpixel_associate_matches_jax(scene, dist_thresh, dot_gate):
    win, live_j, live_t = scene
    twin = jax_map_to_torch(win)
    _, _, H, W = live_t.shape
    s, valid, n = P.projective_associate(
        twin.points, twin.normals, twin.nonpad_mask, P.pack_frame_geom(live_t),
        live_t.intrinsics[:, 0], live_t.poses[:, 0], H, W, dist_thresh, dot_gate, subpixel=True)
    fg = _frame_geom_jax(live_j)
    for b in range(2):
        js, jv, jn = JP.projective_associate(
            win.points[b], win.normals[b], win.nonpad_mask[b], fg[b],
            live_j.intrinsics[b, 0], live_j.poses[b, 0], H, W, dist_thresh, dot_gate, True)
        jv = np.asarray(jv)
        np.testing.assert_array_equal(valid[b].numpy(), jv)
        assert 0 < int(jv.sum()) < jv.shape[0]
        gap = np.abs(s[b].numpy() - np.asarray(js)).max(-1)
        assert gap.max() <= 1e-5 and np.mean(gap[jv] <= 1e-6) >= 0.99
        np.testing.assert_allclose(n[b].numpy(), np.asarray(jn), atol=5e-5, rtol=0)


@pytest.mark.parametrize("H, W", [(1, 5), (4, 1), (1, 1), (3, 4)])
def test_subpixel_associate_at_the_borders_matches_jax(H, W):
    """Frames one pixel wide or high collapse the bilinear corners onto one
    column or row; invalid-depth corners weigh 0, and a point whose corners
    are all invalid is no association (its blended normal is 0)."""
    rng = np.random.RandomState(H * 10 + W)
    geom = np.zeros((1, H * W, 8), np.float32)
    geom[0, :, :3] = rng.randn(H * W, 3) * 0.01 + [0, 0, 1]
    nrm = rng.randn(H * W, 3)
    geom[0, :, 3:6] = nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)
    geom[0, :, 6] = rng.rand(H * W) > 0.3
    geom[0, 0, 6] = 0.0
    K = np.array([[[2.0, 0, (W - 1) / 2, 0], [0, 2.0, (H - 1) / 2, 0], [0, 0, 1, 0], [0, 0, 0, 1]]],
                 np.float32)
    pts = np.concatenate([rng.rand(1, 40, 2) * 0.6 - 0.3, np.ones((1, 40, 1))], -1).astype(
        np.float32)
    nrm_m = np.tile(np.array([[[0, 0, -1.0]]], np.float32), (1, 40, 1))
    mask = np.ones((1, 40), bool)
    pose = np.eye(4, dtype=np.float32)[None]
    s, valid, n = P.projective_associate(*(torch.from_numpy(a) for a in (
        pts, nrm_m, mask, geom, K, pose)), H, W, subpixel=True)
    js, jv, jn = JP.projective_associate(*(jnp.asarray(a[0]) for a in (
        pts, nrm_m, mask, geom, K, pose)), H, W, subpixel=True)
    np.testing.assert_array_equal(valid[0].numpy(), np.asarray(jv))
    np.testing.assert_allclose(s[0].numpy(), np.asarray(js), atol=1e-6, rtol=0)
    np.testing.assert_allclose(n[0].numpy(), np.asarray(jn), atol=1e-5, rtol=0)
    assert torch.isfinite(s).all() and torch.isfinite(n).all()


@pytest.mark.parametrize("solver", ["gradicp", "icp"])
@pytest.mark.parametrize("point_weight, subpixel, loss", [
    (0.25, False, "tukey"),
    (0.0, True, None),
    (1.0, True, "huber"),
], ids=["points_tukey", "subpixel", "points_subpixel_huber"])
def test_point_rows_and_subpixel_solvers_match_jax(scene, solver, point_weight, subpixel, loss):
    """Both solvers with the folded point rows and the bilinear
    association, through both packages' solver functions."""
    win, live_j, live_t = scene
    twin = jax_map_to_torch(win)
    _, _, H, W = live_t.shape
    rng = np.random.RandomState(10)
    init = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    init[:, :3, 3] = 0.003 * rng.randn(2, 3)
    kw = dict(numiters=3, dist_thresh=0.01, dot_gate=0.7071, lookahead_assoc="fresh",
              robust_loss=loss, robust_scale=0.03, sym_normals=True,
              point_weight=point_weight, subpixel=subpixel)
    ours_fn, theirs_fn = (
        (P.point_to_plane_gradICP_projective, JP.point_to_plane_gradICP_projective)
        if solver == "gradicp" else
        (P.point_to_plane_ICP_projective, JP.point_to_plane_ICP_projective))
    ours = ours_fn(
        twin.points, twin.normals, twin.nonpad_mask, P.pack_frame_geom(live_t),
        live_t.intrinsics[:, 0], live_t.poses[:, 0], H, W,
        initial_transform=torch.from_numpy(init), **kw)
    fg = _frame_geom_jax(live_j)
    for b in range(2):
        theirs = theirs_fn(
            win.points[b], win.normals[b], win.nonpad_mask[b], fg[b],
            live_j.intrinsics[b, 0], live_j.poses[b, 0], H, W,
            initial_transform=jnp.asarray(init[b]), **kw)
        np.testing.assert_allclose(ours[b].numpy(), np.asarray(theirs), atol=ATOL_T, rtol=0)
    assert float((ours - torch.from_numpy(init)).abs().max()) > 1e-4


def test_point_block_fold_equals_stacked_rows():
    """The analytic fold of the point rows equals the normal equations of
    the stacked ``(3N, 6)`` point rows (the JAX package's equality oracle),
    and the port's fold equals JAX's."""
    rng = np.random.RandomState(3)
    s = rng.randn(2, 50, 3).astype(np.float32)
    d = (s + 0.02 * rng.randn(2, 50, 3)).astype(np.float32)
    valid = rng.rand(2, 50) > 0.2
    AtA, Atb, err, mass = P._point_block_normal_eq(
        torch.from_numpy(s), torch.from_numpy(d), torch.from_numpy(valid), 0.25, "tukey", 0.03)
    for b in range(2):
        jA, jb, je, jm = JP._point_block_normal_eq(
            jnp.asarray(s[b]), jnp.asarray(d[b]), jnp.asarray(valid[b]), 0.25, "tukey", 0.03)
        np.testing.assert_allclose(AtA[b].numpy(), np.asarray(jA), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(Atb[b].numpy(), np.asarray(jb), atol=1e-6, rtol=1e-5)
        np.testing.assert_allclose(err[b].item(), float(je), rtol=1e-5)
        np.testing.assert_allclose(mass[b].item(), float(jm), rtol=1e-6)
        # the stacked rows: row k of an association is sigma_k [e_k | s x e_k]
        sigma, bw = (x[b].double().numpy() for x in P._point_block(
            torch.from_numpy(s), torch.from_numpy(d), torch.from_numpy(valid), 0.25,
            "tukey", 0.03))
        rows = []
        for i in range(50):
            for k in range(3):
                e = np.eye(3)[k]
                rows.append(sigma[i, k] * np.concatenate([e, np.cross(s[b, i], e)]))
        A = np.stack(rows)
        np.testing.assert_allclose(AtA[b].numpy(), A.T @ A, atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(Atb[b, :, 0].numpy(), A.T @ bw.reshape(-1), atol=1e-6,
                                   rtol=1e-5)


def test_provider_with_point_rows_and_subpixel_matches_jax(scene):
    win, live_j, live_t = scene
    kw = dict(numiters=4, dist_thresh=0.01, dot_gate=0.7071, lookahead_assoc="reuse",
              robust_loss="tukey", robust_scale=0.03, sym_normals=True, point_weight=0.25,
              subpixel=True)
    theirs = JP.ProjectiveOdometryProvider(**kw).provide(win, live_j)
    ours = ProjectiveOdometryProvider(**kw).provide(jax_map_to_torch(win), live_t)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=ATOL_T, rtol=0)


SUBPIXEL_GRAD = dict(odom="gradicp", odom_assoc="projective", odom_subpixel=True,
                     dsratio=2, numiters=3)


@pytest.fixture(scope="module")
def subpixel_grads():
    """jax.grad and the port's gradients of the map and trajectory loss
    through sub-pixel gradICP on the small clip with zeroed depths."""
    data = GP.clip()
    return GP.jax_grads("PointFusion", SUBPIXEL_GRAD, data, True), GP.torch_run(
        "PointFusion", SUBPIXEL_GRAD, data, True)


@pytest.mark.parametrize("wrt", ["depth", "intrinsics"])
def test_subpixel_gradicp_gradient_matches_jax(subpixel_grads, wrt):
    (gd, gk), (_, _, td, tk) = subpixel_grads
    got, want = (td, gd) if wrt == "depth" else (tk, gk)
    assert np.isfinite(want).all() and bool(torch.isfinite(got).all())
    assert GP.max_gap(got, want) <= 1e-3 * float(np.abs(want).max())


def test_subpixel_zero_normal_gradient_is_finite_where_jax_is_not():
    """A sub-pixel association whose four corners carry zero normals (the
    frame's border pixels) blends to a zero normal, whose renormalisation
    takes the norm at 0: ``jax.grad`` gives NaN there (a JAX fault,
    ROADMAP.md queue 3; with symmetric normals it reaches every gradient of
    a sub-pixel gradICP run), torch's norm a zero gradient, so the port's
    gradient stays finite. The forward values are the same."""
    H, W = 4, 5
    geom = np.zeros((1, H * W, 8), np.float32)
    geom[0, :, 2] = 1.0
    geom[0, :, 6] = 1.0  # valid depth, zero normals everywhere
    K = np.array([[[2.0, 0, 2.0, 0], [0, 2.0, 1.5, 0], [0, 0, 1, 0], [0, 0, 0, 1]]], np.float32)
    pts = np.array([[[0.1, 0.2, 1.0], [-0.3, 0.1, 1.0]]], np.float32)
    nrm = np.tile(np.array([[[0, 0, -1.0]]], np.float32), (1, 2, 1))
    mask = np.ones((1, 2), bool)
    pose = np.eye(4, dtype=np.float32)[None]

    def jax_n(p, g):
        return JP.projective_associate(p, jnp.asarray(nrm[0]), jnp.asarray(mask[0]), g,
                                       jnp.asarray(K[0]), jnp.asarray(pose[0]), H, W,
                                       subpixel=True)[2]

    jg = jax.grad(lambda p, g: jnp.sum(jax_n(p, g)), argnums=(0, 1))(
        jnp.asarray(pts[0]), jnp.asarray(geom[0]))
    assert not all(np.isfinite(np.asarray(g)).all() for g in jg)
    tp = torch.tensor(pts, requires_grad=True)
    tg = torch.tensor(geom, requires_grad=True)
    n = P.projective_associate(tp, torch.from_numpy(nrm), torch.from_numpy(mask), tg,
                               torch.from_numpy(K), torch.from_numpy(pose), H, W,
                               subpixel=True)[2]
    n.sum().backward()
    assert bool(torch.isfinite(tp.grad).all()) and bool(torch.isfinite(tg.grad).all())
    np.testing.assert_array_equal(n[0].detach().numpy(), np.asarray(jax_n(
        jnp.asarray(pts[0]), jnp.asarray(geom[0]))))
