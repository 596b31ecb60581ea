"""ICPSLAM in the port held against the JAX package on the CPU: the
aggregate map (``append_masked``, ``update_map_aggregate``), the LM solver
``point_to_plane_ICP`` and its provider, the recency window, and the
pipelines of the slice (``scripts/bench_all.py:223-246``) at a small size.

Tolerances:
- map appends exactly (they copy rows), confidences within 1e-6;
- solver transforms within |dT| <= 1e-5 (the bar ``PARITY.md`` sets for the
  reference goldens); 1-NN indices exactly on the reference's input, and
  all but near-ties (under 1%) on the perturbed batch;
- pipelines: poses within 1e-5 of JAX (float32 solves in another order; the
  easy clip does not amplify them, measured under 1e-6), the aggregate map's
  count exactly (it appends every valid pixel) and its points within 1e-5;
- ``PointFusion(odom='icp')`` against the reference's golden poses within
  1e-3: the JAX package itself is 4.84e-4 from that golden on this clip (its
  6th frame), so the bar is about twice the reference's own gap.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import gradslam_tpu as G  # noqa: E402
from gradslam_torch import ICPSLAM, PointFusion, synthetic_sequence  # noqa: E402
from gradslam_torch.odometry import ICPOdometryProvider  # noqa: E402
from gradslam_torch.odometry.icputils import point_to_plane_ICP  # noqa: E402
from gradslam_torch.slam import update_map_aggregate  # noqa: E402
from gradslam_tpu.odometry import icputils as J  # noqa: E402
from gradslam_tpu.slam.fusionutils import (  # noqa: E402
    update_map_aggregate as jax_update_map_aggregate,
)

from ._parity import both_frames, golden, jax_map_to_torch, msrd  # noqa: E402
from .test_torch_icp import _batched_masked_inputs, _icp_golden_inputs, _t  # noqa: E402


from ._threads import one_thread  # noqa: E402,F401


ATOL_T = 1e-5


@pytest.fixture(autouse=True)
def deterministic():
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(before)


def _map(seed, B=2, cap=30, n=(7, 18), features=True):
    rng = np.random.RandomState(seed)

    def buf(c):
        return rng.randn(B, cap, c).astype(np.float32)

    return G.Pointclouds(
        points=jnp.asarray(buf(3)), num_points=jnp.asarray(n, jnp.int32),
        normals=jnp.asarray(buf(3)), colors=jnp.asarray(buf(3)),
        features=jnp.asarray(buf(1)) if features else None,
        num_dropped=jnp.asarray([1, 0], jnp.int32),
    )


def _assert_maps_equal(ours, theirs):
    for name in ("points", "normals", "colors", "features"):
        a, b = getattr(ours, name), getattr(theirs, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b), err_msg=name)
    np.testing.assert_array_equal(ours.num_points.numpy(), np.asarray(theirs.num_points))
    np.testing.assert_array_equal(ours.num_dropped.numpy(), np.asarray(theirs.num_dropped))


@pytest.mark.parametrize("M, frac", [(10, 0.7), (25, 0.9), (40, 1.0)],
                         ids=["fits", "overflows_one", "overflows_both"])
def test_append_masked_matches_jax_and_aliases_nothing(M, frac):
    jmap = _map(0)
    rng = np.random.RandomState(1)
    rows = {k: rng.randn(2, M, c).astype(np.float32)
            for k, c in (("points", 3), ("normals", 3), ("colors", 3), ("features", 1))}
    mask = rng.rand(2, M) < frac
    theirs = jmap.append_masked(jnp.asarray(rows["points"]), jnp.asarray(mask),
                                **{k: jnp.asarray(v) for k, v in rows.items() if k != "points"})
    tmap = jax_map_to_torch(jmap)
    old = {k: getattr(tmap, k).clone() for k in ("points", "normals", "colors", "features",
                                                  "num_points", "num_dropped")}
    ours = tmap.append_masked(torch.from_numpy(rows["points"]), torch.from_numpy(mask),
                              **{k: torch.from_numpy(v) for k, v in rows.items()
                                 if k != "points"})
    _assert_maps_equal(ours, theirs)
    if M >= 25:
        assert (ours.num_dropped > tmap.num_dropped).any()
    # the earlier map (and any view of it) is untouched
    for k, v in old.items():
        np.testing.assert_array_equal(getattr(tmap, k).numpy(), v.numpy(), err_msg=k)
        assert getattr(ours, k).data_ptr() != getattr(tmap, k).data_ptr()


def test_append_points_and_missing_buffers_match_jax():
    jmap = _map(2, features=False)
    other = _map(3, cap=12, n=(12, 4))
    theirs = jmap.append_points(other)
    ours = jax_map_to_torch(jmap).append_points(jax_map_to_torch(other))
    _assert_maps_equal(ours, theirs)
    assert ours.features is None


def test_append_masked_is_differentiable():
    tmap = jax_map_to_torch(_map(4))
    pts = torch.randn(2, 6, 3, requires_grad=True)
    mask = torch.tensor([[True, False, True, True, False, True]] * 2)
    out = tmap.append_masked(pts, mask)
    out.points.sum().backward()
    np.testing.assert_array_equal(pts.grad[:, :, 0].numpy(), mask.float().numpy())


def _frames_with_holes(seed, B=2, L=2, H=12, W=16):
    rgb, depth, K, P = synthetic_sequence(B, L, H, W, seed=seed)
    rng = np.random.RandomState(seed)
    depth = depth * (rng.rand(*depth.shape) > 0.3)  # invalid pixels, different per sequence
    return both_frames(rgb, depth.astype(np.float32), K, P)


@pytest.mark.parametrize("cap, features", [(400, False), (250, False), (400, True)],
                         ids=["fits", "overflows", "with_confidence"])
def test_update_map_aggregate_matches_jax(cap, features):
    jf, tf = _frames_with_holes(5)
    jmap = G.Pointclouds.empty(2, cap, has_normals=True, has_colors=True,
                               feature_dim=1 if features else None)
    tmap = jax_map_to_torch(jmap)
    for i in range(2):
        jmap = jax_update_map_aggregate(jmap, jf[:, i])
        tmap = update_map_aggregate(tmap, tf[:, i])
        for name in ("points", "normals", "colors"):
            np.testing.assert_allclose(getattr(tmap, name).numpy(),
                                       np.asarray(getattr(jmap, name)), atol=1e-6, rtol=0)
        if features:
            np.testing.assert_allclose(tmap.features.numpy(), np.asarray(jmap.features),
                                       atol=1e-6, rtol=0)
        np.testing.assert_array_equal(tmap.num_points.numpy(), np.asarray(jmap.num_points))
        np.testing.assert_array_equal(tmap.num_dropped.numpy(), np.asarray(jmap.num_dropped))
    if cap == 250:
        assert (tmap.num_dropped > 0).all()
    else:
        assert tmap.num_points[0] != tmap.num_points[1]


def test_update_map_aggregate_refuses_user_features():
    """A map with user feature channels refuses a frame without a feature
    plane, as the JAX package does (user channels are ported:
    tests/port/test_torch_features.py)."""
    jf, tf = _frames_with_holes(6, B=1, L=1)
    jmap = G.Pointclouds.empty(1, 300, feature_dim=3)
    with pytest.raises(ValueError, match="2 user feature channel"):
        update_map_aggregate(jax_map_to_torch(jmap), tf[:, 0])
    with pytest.raises(ValueError, match="2 user feature channel"):
        jax_update_map_aggregate(jmap, jf[:, 0])


def test_icp_meets_reference_golden_and_jax():
    src, tgt, nrm = _icp_golden_inputs()
    ours, idx = point_to_plane_ICP(_t(src), _t(tgt), _t(nrm), numiters=10)
    assert ours.shape == (4, 4) and idx.shape == (src.shape[0],)
    np.testing.assert_allclose(ours.numpy(), golden("icp_transform"), atol=ATOL_T, rtol=0)
    theirs, jidx = J.point_to_plane_ICP(jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(nrm),
                                        numiters=10)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=ATOL_T, rtol=0)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))


@pytest.mark.parametrize("lookahead, loss, gate, dist", [
    ("fresh", None, None, None),
    ("reuse", None, None, 0.05),
    ("fresh", "tukey", -1.0, 0.05),
    ("reuse", "huber", 0.7071, 0.05),
])
def test_icp_batched_masked_matches_jax(lookahead, loss, gate, dist):
    src, tgt, nrm, src_mask, tgt_mask = _batched_masked_inputs()
    rng = np.random.RandomState(1)
    src_n = (nrm[:, :src.shape[1]] + 0.2 * rng.randn(*src.shape)).astype(np.float32)
    src_n = src_n if gate is not None else None
    init = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    init[:, :3, 3] = 0.01 * rng.randn(2, 3)
    kw = dict(numiters=6, dist_thresh=dist, lookahead_assoc=lookahead, robust_loss=loss,
              robust_scale=0.03, dot_gate=gate)
    ours, idx = point_to_plane_ICP(
        _t(src), _t(tgt), _t(nrm), initial_transform=_t(init), src_mask=_t(src_mask),
        tgt_mask=_t(tgt_mask), src_normals=None if src_n is None else _t(src_n), **kw)
    for b in range(2):
        theirs, jidx = J.point_to_plane_ICP(
            jnp.asarray(src[b]), jnp.asarray(tgt[b]), jnp.asarray(nrm[b]),
            initial_transform=jnp.asarray(init[b]), src_mask=jnp.asarray(src_mask[b]),
            tgt_mask=jnp.asarray(tgt_mask[b]),
            src_normals=None if src_n is None else jnp.asarray(src_n[b]), **kw)
        np.testing.assert_allclose(ours[b].numpy(), np.asarray(theirs), atol=ATOL_T, rtol=0)
        # the last association is taken at iterates that differ by float32
        # rounding, which may flip a 1-NN near-tie
        assert (idx[b].numpy() != np.asarray(jidx)).mean() < 1e-2
    assert torch.isfinite(ours).all()


def test_icp_provider_matches_jax():
    m = msrd()
    jf, _ = both_frames(m["colors"], m["depths"], m["intrinsics"], m["poses"])
    jmap = J.downsample_rgbdimages(jf[:, 0], 4)
    maps = G.Pointclouds(points=jmap.points, num_points=jmap.num_points, normals=jmap.normals)
    jlive = J.downsample_rgbdimages(jf[:, 1].with_poses(jf.poses[:, 0:1]), 4)
    kw = dict(numiters=4, dist_thresh=0.01, lookahead_assoc="reuse", robust_loss="tukey",
              robust_scale=0.03, dot_gate=0.7071)
    theirs = G.ICPOdometryProvider(**kw).provide(maps, jlive)
    ours = ICPOdometryProvider(**kw).provide(jax_map_to_torch(maps), jax_map_to_torch(jlive))
    assert ours.shape == (2, 1, 4, 4)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=ATOL_T, rtol=0)
    with pytest.raises(ValueError, match="normals"):
        ICPOdometryProvider().provide(jax_map_to_torch(jlive.__class__(
            points=jlive.points, num_points=jlive.num_points)), jax_map_to_torch(jlive))
    with pytest.raises(ValueError, match="cosine"):
        ICPOdometryProvider(dot_gate=1.5)


@pytest.mark.parametrize("num_points", [(0, 5), (9, 30), (40, 64), (64, 17)])
def test_recency_window_per_sequence_matches_jax(num_points):
    """``icp_window_frames`` cuts each sequence's own last ``rows`` map rows
    (B=2, different counts, windows at the start, middle and end)."""
    jmap = _map(7, cap=64, n=num_points)
    H, W = 4, 6  # rows = 1 * 4 * 6 = 24
    theirs = G.ICPSLAM(odom="icp", icp_window_frames=1)._icp_target_window(jmap, H, W)
    ours = ICPSLAM(odom="icp", icp_window_frames=1)._icp_target_window(
        jax_map_to_torch(jmap), H, W)
    assert ours.points.shape == (2, 24, 3) and ours.colors is None
    np.testing.assert_array_equal(ours.points.numpy(), np.asarray(theirs.points))
    np.testing.assert_array_equal(ours.normals.numpy(), np.asarray(theirs.normals))
    np.testing.assert_array_equal(ours.num_points.numpy(), np.asarray(theirs.num_points))
    # a window as large as the map is the whole map
    whole = ICPSLAM(odom="icp", icp_window_frames=3)._icp_target_window(
        jax_map_to_torch(jmap), H, W)
    assert whole.points.shape == (2, 64, 3)


# The slice's configurations (scripts/bench_all.py:223-246) at 64x48 on a
# 4-frame clip, strides and iterations cut with the size (dsratio 4 -> 2,
# numiters 10 -> 4, the pyramid (8, 8), (4, 3) -> (4, 3), (2, 2)), and the
# projective LM solver in the same pipeline.
SLICE = {
    "flat": dict(odom="icp", dsratio=2, numiters=4),
    "window": dict(odom="icp", dsratio=2, numiters=4, icp_window_frames=2),
    "window_pyramid": dict(odom="icp", pyramid=[(4, 3), (2, 2)], icp_window_frames=2),
    "gt": dict(odom="gt"),
    "projective_lm": dict(odom="icp", odom_assoc="projective", dsratio=2, numiters=4),
}


@pytest.mark.parametrize("name", list(SLICE))
def test_slice_configuration_matches_jax(name):
    L, H, W = 4, 48, 64
    rgb, depth, K, P = synthetic_sequence(1, L, H, W)
    jf, tf = both_frames(rgb, depth, K, P)
    sched = [(2, 2 * H * W), (2, 4 * H * W)]
    jpc, jposes = G.ICPSLAM(map_capacity=sched, **SLICE[name])(jf)
    tpc, tposes = ICPSLAM(map_capacity=sched, **SLICE[name])(tf)
    np.testing.assert_allclose(tposes.numpy(), np.asarray(jposes), atol=ATOL_T, rtol=0)
    assert int(tpc.num_points[0]) == int(jpc.num_points[0]) == L * H * W
    assert int(tpc.num_dropped[0]) == int(jpc.num_dropped[0]) == 0
    assert tpc.capacity == 4 * H * W and tpc.features is None
    np.testing.assert_allclose(tpc.points.numpy(), np.asarray(jpc.points), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tpc.colors.numpy(), np.asarray(jpc.colors), atol=0, rtol=0)
    # the synthetic clip is easy: tracking stays on the ground truth
    assert np.abs(tposes.numpy()[0, :, :3, 3] - P[0, :, :3, 3]).max() < 1e-3


def test_windowed_icpslam_on_a_batch_matches_jax():
    """B=2 with different map counts per sequence (holes in one depth
    stream), so the recency windows start at different rows."""
    rgb, depth, K, P = synthetic_sequence(2, 4, 36, 48, seed=3)
    rng = np.random.RandomState(3)
    depth[1] = depth[1] * (rng.rand(*depth[1].shape) > 0.25)
    jf, tf = both_frames(rgb, depth.astype(np.float32), K, P)
    kw = dict(odom="icp", dsratio=2, numiters=4, icp_window_frames=1)
    jpc, jposes = G.ICPSLAM(**kw)(jf)
    tpc, tposes = ICPSLAM(**kw)(tf)
    np.testing.assert_allclose(tposes.numpy(), np.asarray(jposes), atol=ATOL_T, rtol=0)
    np.testing.assert_array_equal(tpc.num_points.numpy(), np.asarray(jpc.num_points))
    assert tpc.num_points[0] > tpc.num_points[1]


def test_pointfusion_icp_meets_reference_golden_and_jax():
    m = msrd()
    jf, tf = both_frames(m["colors"], m["depths"], m["intrinsics"], m["poses"])
    jpc, jposes = G.PointFusion(odom="icp", dsratio=4, numiters=20)(jf)
    tpc, tposes = PointFusion(odom="icp", dsratio=4, numiters=20)(tf)
    np.testing.assert_allclose(tposes.numpy(), np.asarray(jposes), atol=ATOL_T, rtol=0)
    assert np.abs(tposes.numpy() - golden("pointfusion_icp_poses")).max() < 1e-3
    np.testing.assert_array_equal(tpc.num_points.numpy(), np.asarray(jpc.num_points))
    assert (tpc.num_dropped == 0).all()
