"""The port's GradICP solver held against the JAX package on the CPU and
against the reference's golden transform. On the CPU the 1-NN search is the
plain version, which ``test_torch_knn.py`` holds to the Pallas kernel.

Tolerances: solver transforms within |dT| <= 1e-5 (the bar ``PARITY.md``
sets for the reference goldens); linear-system rows and solutions within
1e-5; downsampled clouds exactly (gathers and compaction only); robust
weights and the guarded step within 1e-6; the normal gate exactly."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import gradslam_tpu as G  # noqa: E402
from gradslam_torch.odometry import GradICPOdometryProvider  # noqa: E402
from gradslam_torch.odometry import icputils as T  # noqa: E402
from gradslam_torch.odometry.icputils import (  # noqa: E402
    downsample_rgbdimages,
    gauss_newton_solve,
    point_to_plane_gradICP,
    solve_linear_system,
)
from gradslam_tpu.odometry import icputils as J  # noqa: E402

from ._parity import both_frames, golden, jax_map_to_torch, msrd  # noqa: E402

ATOL_T = 1e-5


def _t(x):
    return torch.from_numpy(np.array(x))


def _icp_golden_inputs():
    return golden("icp_src"), golden("icp_tgt"), golden("icp_tgt_normals")


def _batched_masked_inputs():
    """Two cloud pairs from the golden clouds: the second is perturbed and its
    target carries NaN padding behind a mask, as the map window does."""
    src, tgt, nrm = _icp_golden_inputs()
    rng = np.random.RandomState(0)
    N, M = src.shape[0], tgt.shape[0]
    src2 = src + 0.002 * rng.randn(N, 3).astype(np.float32)
    tgt_mask = np.ones((2, M), bool)
    tgt_mask[1, rng.rand(M) < 0.3] = False
    tgt_b = np.stack([tgt, tgt]).copy()
    tgt_b[1][~tgt_mask[1]] = np.nan
    src_mask = np.ones((2, N), bool)
    src_mask[1, N - 200:] = False
    return (np.stack([src, src2]), tgt_b, np.stack([nrm, nrm]), src_mask, tgt_mask)


def test_gradicp_matches_reference_golden_and_jax():
    src, tgt, nrm = _icp_golden_inputs()
    ours, idx = point_to_plane_gradICP(_t(src), _t(tgt), _t(nrm), numiters=10)
    assert ours.shape == (4, 4) and idx.shape == (src.shape[0],)
    np.testing.assert_allclose(ours.numpy(), golden("gradicp_transform"), atol=ATOL_T, rtol=0)
    theirs, jidx = J.point_to_plane_gradICP(
        jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(nrm), numiters=10
    )
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=ATOL_T, rtol=0)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))


@pytest.mark.parametrize("dist_thresh", [None, 0.05])
def test_gradicp_batched_masked_matches_jax(dist_thresh):
    src, tgt, nrm, src_mask, tgt_mask = _batched_masked_inputs()
    rng = np.random.RandomState(1)
    init = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    init[:, :3, 3] = 0.01 * rng.randn(2, 3)
    ours, _ = point_to_plane_gradICP(
        _t(src), _t(tgt), _t(nrm), initial_transform=_t(init), numiters=6,
        dist_thresh=dist_thresh, src_mask=_t(src_mask), tgt_mask=_t(tgt_mask),
    )
    for b in range(2):
        theirs, _ = J.point_to_plane_gradICP(
            jnp.asarray(src[b]), jnp.asarray(tgt[b]), jnp.asarray(nrm[b]),
            initial_transform=jnp.asarray(init[b]), numiters=6,
            dist_thresh=dist_thresh, src_mask=jnp.asarray(src_mask[b]),
            tgt_mask=jnp.asarray(tgt_mask[b]),
        )
        np.testing.assert_allclose(ours[b].numpy(), np.asarray(theirs), atol=ATOL_T, rtol=0)
    assert torch.isfinite(ours).all()


def test_gauss_newton_rows_match_jax():
    src, tgt, nrm, src_mask, tgt_mask = _batched_masked_inputs()
    A, b, idx = gauss_newton_solve(
        _t(src), _t(tgt), _t(nrm), _t(src_mask), _t(tgt_mask), dist_thresh=0.05
    )
    for k in range(2):
        jA, jb, jidx = J.gauss_newton_solve(
            jnp.asarray(src[k]), jnp.asarray(tgt[k]), jnp.asarray(nrm[k]),
            jnp.asarray(src_mask[k]), jnp.asarray(tgt_mask[k]), dist_thresh=0.05,
        )
        np.testing.assert_array_equal(idx[k].numpy(), np.asarray(jidx))
        np.testing.assert_allclose(A[k].numpy(), np.asarray(jA), atol=1e-6, rtol=0)
        np.testing.assert_allclose(b[k].numpy(), np.asarray(jb), atol=1e-6, rtol=0)
    # masked-out source rows add nothing to the normal equations
    assert (A[1, src_mask[1] == 0] == 0).all()


def test_solve_linear_system_matches_jax():
    rng = np.random.RandomState(2)
    A = rng.randn(3, 50, 6).astype(np.float32)
    b = rng.randn(3, 50, 1).astype(np.float32)
    damp = np.array([1e-8, 1e-2, 1.0], np.float32)
    ours = solve_linear_system(_t(A), _t(b), _t(damp))
    assert ours.shape == (3, 6, 1)
    for k in range(3):
        theirs = J.solve_linear_system(jnp.asarray(A[k]), jnp.asarray(b[k]), damp[k])
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(theirs), atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError):
        solve_linear_system(_t(A[0]), _t(b[0]))


def test_downsample_rgbdimages_matches_jax():
    m = msrd()
    jf, tf = both_frames(m["colors"], m["depths"], m["intrinsics"], m["poses"])
    ours = downsample_rgbdimages(tf[:, 1], 4)
    theirs = J.downsample_rgbdimages(jf[:, 1], 4)
    np.testing.assert_array_equal(ours.num_points.numpy(), np.asarray(theirs.num_points))
    for name in ("points", "normals", "colors"):
        np.testing.assert_allclose(
            getattr(ours, name).numpy(), np.asarray(getattr(theirs, name)), atol=1e-6, rtol=0
        )
    with pytest.raises(ValueError):
        downsample_rgbdimages(tf, 4)  # sequence length must be 1


def test_provider_matches_jax():
    src, tgt, nrm, src_mask, tgt_mask = _batched_masked_inputs()
    tgt = np.where(tgt_mask[..., None], tgt, 0.0).astype(np.float32)
    n_src, n_tgt = src_mask.sum(-1), tgt_mask.sum(-1)
    # providers read clouds as padded buffers: live rows first
    order_t = np.argsort(~tgt_mask, axis=1, kind="stable")
    order_s = np.argsort(~src_mask, axis=1, kind="stable")
    take = np.take_along_axis
    maps = G.Pointclouds(points=jnp.asarray(take(tgt, order_t[..., None], 1)),
                         num_points=jnp.asarray(n_tgt, jnp.int32),
                         normals=jnp.asarray(take(nrm, order_t[..., None], 1)))
    live = G.Pointclouds(points=jnp.asarray(take(src, order_s[..., None], 1)),
                         num_points=jnp.asarray(n_src, jnp.int32))
    theirs = G.GradICPOdometryProvider(numiters=5).provide(maps, live)
    ours = GradICPOdometryProvider(numiters=5).provide(
        jax_map_to_torch(maps), jax_map_to_torch(live)
    )
    assert ours.shape == (2, 1, 4, 4)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=ATOL_T, rtol=0)
    with pytest.raises(ValueError):
        GradICPOdometryProvider().provide(jax_map_to_torch(live), jax_map_to_torch(live))


@pytest.mark.parametrize("loss", [None, "huber", "tukey"])
def test_robust_weights_match_jax(loss):
    rng = np.random.RandomState(4)
    r = np.concatenate([[0.0, -0.0, 0.03, -0.03, 1e-13, 5.0],
                        rng.randn(200) * 0.05]).astype(np.float32)[:, None]
    ours = T.robust_weights(_t(r), loss, 0.03)
    theirs = J.robust_weights(jnp.asarray(r), loss, 0.03)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=1e-6, rtol=0)
    assert torch.isfinite(ours).all()
    with pytest.raises(ValueError):
        T.robust_weights(_t(r), "cauchy", 0.03)


@pytest.mark.parametrize("gate", [-1.0, 0.0, 0.7071, 1.0])
def test_normal_gate_matches_jax(gate):
    rng = np.random.RandomState(5)
    n1 = rng.randn(300, 3).astype(np.float32) * rng.rand(300, 1).astype(np.float32)
    n2 = rng.randn(300, 3).astype(np.float32) * 0.3
    n1[:5] = 0.0  # padding rows with zero normals
    n2[5:10] = -n1[5:10] * 2.0  # exactly anti-parallel, non-unit
    ours = T._normal_gate(_t(n1), _t(n2), gate)
    theirs = J._normal_gate(jnp.asarray(n1), jnp.asarray(n2), gate)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
    # zero-normal padding rows: admitted by non-positive gates only
    assert bool(ours[:5].all()) == (gate <= 0)


@pytest.mark.parametrize("case", ["all_rejected", "healthy", "huge_step"])
def test_guard_robust_step_matches_jax(case):
    rng = np.random.RandomState(6)
    N = 40
    src = (rng.randn(N, 3) * 0.3 + [0.0, 0.0, 1.5]).astype(np.float32)
    mask = rng.rand(N) < 0.8
    A = rng.randn(N, 6).astype(np.float32)
    xi = (rng.randn(6, 1) * 0.01).astype(np.float32)
    if case == "all_rejected":
        A[:] = 0.0
        xi = (rng.randn(6, 1) * 1e6).astype(np.float32)
    if case == "huge_step":
        xi = (rng.randn(6, 1) * 3.0).astype(np.float32)
    ours = T._guard_robust_step(_t(xi[:, 0])[None], _t(A)[None], 0.03, _t(src)[None],
                                _t(mask)[None])
    theirs = J._guard_robust_step(jnp.asarray(xi), jnp.asarray(A), 0.03, jnp.asarray(src),
                                  jnp.asarray(mask))
    np.testing.assert_allclose(ours[0].numpy(), np.asarray(theirs)[:, 0], atol=1e-6, rtol=1e-6)
    if case == "all_rejected":
        assert (ours == 0).all()
    ours_nomask = T._guard_robust_step(_t(xi[:, 0])[None], _t(A)[None], 0.03, _t(src)[None], None)
    theirs_nomask = J._guard_robust_step(jnp.asarray(xi), jnp.asarray(A), 0.03,
                                         jnp.asarray(src), None)
    np.testing.assert_allclose(ours_nomask[0].numpy(), np.asarray(theirs_nomask)[:, 0],
                               atol=1e-6, rtol=1e-6)


def _tilted_normals(nrm):
    rng = np.random.RandomState(7)
    return (nrm + 0.2 * rng.randn(*nrm.shape)).astype(np.float32)


@pytest.mark.parametrize("lookahead, loss, gate", [
    ("reuse", None, None),
    ("fresh", "tukey", None),
    ("reuse", "huber", 0.7071),
    ("reuse", "tukey", 0.7071),
    ("fresh", None, -1.0),
])
def test_gated_robust_reuse_gradicp_matches_jax(lookahead, loss, gate):
    src, tgt, nrm, src_mask, tgt_mask = _batched_masked_inputs()
    src_n = _tilted_normals(src * 0.0 + nrm[:, :src.shape[1]]) if gate is not None else None
    rng = np.random.RandomState(1)
    init = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    init[:, :3, 3] = 0.01 * rng.randn(2, 3)
    kw = dict(numiters=6, dist_thresh=0.05, lookahead_assoc=lookahead, robust_loss=loss,
              robust_scale=0.03, dot_gate=gate)
    ours, _ = point_to_plane_gradICP(
        _t(src), _t(tgt), _t(nrm), initial_transform=_t(init), src_mask=_t(src_mask),
        tgt_mask=_t(tgt_mask), src_normals=None if src_n is None else _t(src_n), **kw)
    for b in range(2):
        theirs, _ = J.point_to_plane_gradICP(
            jnp.asarray(src[b]), jnp.asarray(tgt[b]), jnp.asarray(nrm[b]),
            initial_transform=jnp.asarray(init[b]), src_mask=jnp.asarray(src_mask[b]),
            tgt_mask=jnp.asarray(tgt_mask[b]),
            src_normals=None if src_n is None else jnp.asarray(src_n[b]), **kw)
        np.testing.assert_allclose(ours[b].numpy(), np.asarray(theirs), atol=ATOL_T, rtol=0)
    assert torch.isfinite(ours).all()


def test_gate_arguments_come_in_pairs():
    src, tgt, nrm = (_t(a) for a in _icp_golden_inputs())
    with pytest.raises(ValueError, match="dot_gate requires"):
        point_to_plane_gradICP(src, tgt, nrm, numiters=1, dot_gate=0.5)
    with pytest.raises(ValueError, match="src_normals"):
        point_to_plane_gradICP(src, tgt, nrm, numiters=1, src_normals=nrm[: src.shape[0]])
    with pytest.raises(ValueError, match="lookahead"):
        point_to_plane_gradICP(src, tgt, nrm, numiters=1, lookahead_assoc="bogus")


def test_provider_with_options_matches_jax():
    m = msrd()
    jf, tf = both_frames(m["colors"], m["depths"], m["intrinsics"], m["poses"])
    jmap = J.downsample_rgbdimages(jf[:, 0], 4)
    maps = G.Pointclouds(points=jmap.points, num_points=jmap.num_points, normals=jmap.normals)
    jlive = J.downsample_rgbdimages(jf[:, 1].with_poses(jf.poses[:, 0:1]), 4)
    kw = dict(numiters=5, dist_thresh=0.01, lookahead_assoc="reuse", robust_loss="tukey",
              robust_scale=0.03, dot_gate=0.7071)
    theirs = G.GradICPOdometryProvider(**kw).provide(maps, jlive)
    ours = GradICPOdometryProvider(**kw).provide(jax_map_to_torch(maps), jax_map_to_torch(jlive))
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=ATOL_T, rtol=0)
    with pytest.raises(ValueError, match="cosine"):
        GradICPOdometryProvider(dot_gate=1.5)
