"""The dense reference fusion path of the port (``are_points_close``,
``are_normals_similar``, ``find_similar_map_points``,
``find_best_unique_correspondences``, ``find_correspondences``,
``fuse_with_map``) held on the CPU against the JAX package's dense chain on
``tests/data/msrd_b2s3`` and the hand-made winner tables of
``tests/slam/test_fusionutils.py``, against the port's own fast path
(``update_map_fusion(association='sort_full')``) as JAX's
``test_windowed_equals_dense`` holds them, and over the whole msrd clip
against the reference gradslam's own maps (``tests/data/ref_golden``).

Tolerances: winners, correspondences and counts exact; fused maps within
1e-5 (msrd's 0-255 colours within 1e-5 of their size); the reference goldens at ``PARITY.md``'s bars (counts within 0.2%,
mean chamfer below 1e-3 m, confidence mass within 1e-4)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import gradslam_tpu as G  # noqa: E402
import gradslam_tpu.slam.fusionutils as JF  # noqa: E402
import gradslam_torch.slam.fusionutils as TF  # noqa: E402
from gradslam_torch import Pointclouds  # noqa: E402
from gradslam_torch.datasets import synthetic_sequence  # noqa: E402
from gradslam_torch.structures import pointclouds as pointclouds_module  # noqa: E402

from ._parity import both_frames, golden, jax_map_to_torch, msrd  # noqa: E402

DIST_TH, DOT_TH, SIGMA = 0.05, float(np.cos(np.radians(20))), 0.6
MAP_ATOL = 1e-5


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# --------------------------------------------------------------------- #
# Predicates
# --------------------------------------------------------------------- #
def test_predicates_match_jax():
    rng = np.random.RandomState(0)
    a = rng.randn(2, 50, 3).astype(np.float32)
    b = (a + 0.04 * rng.randn(2, 50, 3)).astype(np.float32)
    for th in (0.01, 0.05, 0.1):
        np.testing.assert_array_equal(TF.are_points_close(_t(a), _t(b), th).numpy(),
                                      np.asarray(JF.are_points_close(a, b, th)))
    na = a / np.linalg.norm(a, axis=-1, keepdims=True)
    nb = b / np.linalg.norm(b, axis=-1, keepdims=True)
    for th in (0.5, DOT_TH, 0.999):
        np.testing.assert_array_equal(TF.are_normals_similar(_t(na), _t(nb), th).numpy(),
                                      np.asarray(JF.are_normals_similar(na, nb, th)))
    np.testing.assert_array_equal(
        TF.are_points_close(torch.zeros(3, 3), torch.tensor(
            [[0.0, 0, 0.01], [0, 0, 0.2], [0, 0, 0.04]]), 0.05).numpy(), [True, False, True])
    for fn in (TF.are_points_close, TF.are_normals_similar):
        with pytest.raises(ValueError, match="same shape"):
            fn(torch.zeros(2, 3), torch.zeros(3, 3), 0.1)


# --------------------------------------------------------------------- #
# Winner tables (tests/slam/test_fusionutils.py:107-176)
# --------------------------------------------------------------------- #
def _tiny_frame(H=2, W=2):
    """A flat plane at z = 1 with the identity pose and unit focal length
    centred on the image, as the JAX tests' ``tiny_frame``."""
    rgb = np.full((1, 1, H, W, 3), 0.5, np.float32)
    depth = np.ones((1, 1, H, W, 1), np.float32)
    K = np.eye(4, dtype=np.float32)
    K[0, 2], K[1, 2] = (W - 1) / 2.0, (H - 1) / 2.0
    poses = np.eye(4, dtype=np.float32)[None, None]
    return both_frames(rgb, depth, K[None, None], poses)


def _winner_case(ccounts, ray_points):
    """Every candidate projects to pixel (0, 0) of a 2x2 frame."""
    n = len(ccounts)
    normals = np.zeros((1, n, 3), np.float32)
    normals[..., 2] = 1.0
    arrays = dict(points=np.asarray([ray_points], np.float32), num_points=np.array([n]),
                  normals=normals, colors=np.zeros((1, n, 3), np.float32),
                  features=np.asarray([[[c] for c in ccounts]], np.float32))
    jpc = G.Pointclouds(**{k: jnp.asarray(v) for k, v in arrays.items()})
    pc = Pointclouds(**{k: _t(v) for k, v in arrays.items()})
    jactive = JF.ActiveMapPoints(valid=jnp.ones((1, n), bool),
                                 pix_h=jnp.zeros((1, n), jnp.int32),
                                 pix_w=jnp.zeros((1, n), jnp.int32))
    active = TF.ActiveMapPoints(valid=torch.ones(1, n, dtype=torch.bool),
                                pix_h=torch.zeros(1, n, dtype=torch.int64),
                                pix_w=torch.zeros(1, n, dtype=torch.int64))
    jf, tf = _tiny_frame()
    return (pc, tf, active), (jpc, jf, jactive)


FP = [-0.5, -0.5]  # the frame's vertex at pixel (0, 0) is (-0.5, -0.5, 1)
WINNER_CASES = {
    "max ccount": ([1.0, 3.0, 2.0], [[0, 0, 1.0]] * 3, [False, True, False]),
    "min ray distance": ([2.0, 2.0, 2.0], [FP + [1.3], FP + [1.1], FP + [1.2]],
                         [False, True, False]),
    "min index": ([2.0, 2.0], [FP + [1.1], FP + [1.1]], [True, False]),
    "ccount before distance": ([1.0, 2.0], [FP + [1.0], FP + [1.3]], [False, True]),
    "one candidate": ([1.0], [[0, 0, 1.0]], [True]),
}


@pytest.mark.parametrize("case", sorted(WINNER_CASES))
def test_winner_tables_match_jax_and_the_reference(case):
    ccounts, ray_points, expected = WINNER_CASES[case]
    ours_in, theirs_in = _winner_case(ccounts, ray_points)
    winner, corr = TF.find_best_unique_correspondences(*ours_in)
    jwinner, jcorr = JF.find_best_unique_correspondences(*theirs_in)
    np.testing.assert_array_equal(winner[0].numpy(), expected)
    np.testing.assert_array_equal(winner.numpy(), np.asarray(jwinner))
    np.testing.assert_array_equal(corr.numpy(), np.asarray(jcorr))
    corr = corr.numpy().reshape(2, 2)
    assert corr[0, 0] and not corr.ravel()[1:].any()


def test_similar_mask_restricts_the_candidates():
    ours_in, theirs_in = _winner_case([1.0, 3.0, 2.0], [[0, 0, 1.0]] * 3)
    similar = np.array([[True, False, True]])
    winner, _ = TF.find_best_unique_correspondences(*ours_in, _t(similar))
    jwinner, _ = JF.find_best_unique_correspondences(*theirs_in, jnp.asarray(similar))
    np.testing.assert_array_equal(winner.numpy(), np.asarray(jwinner))
    np.testing.assert_array_equal(winner[0].numpy(), [False, False, True])


def test_refusals_match_jax():
    (pc, tf, active), (jpc, jf, jactive) = _winner_case([1.0, 2.0], [[0, 0, 1.0]] * 2)
    import dataclasses

    cases = [
        (lambda m, f, a: TF.find_similar_map_points(m, f, a, 0.1, 0.9),
         lambda m, f, a: JF.find_similar_map_points(m, f, a, 0.1, 0.9), "normals"),
        (lambda m, f, a: TF.find_best_unique_correspondences(m, f, a),
         lambda m, f, a: JF.find_best_unique_correspondences(m, f, a), "features"),
    ]
    for ours, theirs, field in cases:
        with pytest.raises(ValueError) as e1:
            ours(dataclasses.replace(pc, **{field: None}), tf, active)
        with pytest.raises(ValueError) as e2:
            theirs(dataclasses.replace(jpc, **{field: None}), jf, jactive)
        assert str(e1.value) == str(e2.value)
    winner = torch.ones(1, 2, dtype=torch.bool)
    corr = torch.zeros(1, 4, dtype=torch.bool)
    for change in (dict(colors=None), dict(normals=None),
                   dict(features=torch.ones(1, 2, 2))):  # quantized or user channels
        jchange = {k: None if v is None else jnp.asarray(v.numpy()) for k, v in change.items()}
        with pytest.raises(ValueError) as e1:
            TF.fuse_with_map(dataclasses.replace(pc, **change), tf, active, winner, corr, SIGMA)
        with pytest.raises(ValueError) as e2:
            JF.fuse_with_map(dataclasses.replace(jpc, **jchange), jf, jactive,
                             jnp.asarray(winner.numpy()), jnp.asarray(corr.numpy()), SIGMA)
        assert str(e1.value) == str(e2.value)
        assert "quantized-layout maps are supported by update_map_fusion only" in str(e1.value)


# --------------------------------------------------------------------- #
# The dense chain against JAX's on msrd_b2s3
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def msrd_frames():
    m = msrd()
    return both_frames(m["colors"], m["depths"], m["intrinsics"], m["poses"])


def _jax_map_after(jf, frames, capacity):
    jpc = G.Pointclouds.empty(2, capacity)
    for s in range(frames):
        jpc = JF.update_map_fusion(jpc, jf[:, s], DIST_TH, DOT_TH, SIGMA)
    return jpc


@pytest.mark.parametrize("frame", [1, 2])
def test_dense_chain_matches_jax(msrd_frames, frame):
    jf, tf = msrd_frames
    jpc = _jax_map_after(jf, frame, 3 * 120 * 160)
    pc = jax_map_to_torch(jpc)
    active, winner, corr = TF.find_correspondences(pc, tf[:, frame], DIST_TH, DOT_TH)
    jactive, jwinner, jcorr = JF.find_correspondences(jpc, jf[:, frame], DIST_TH, DOT_TH)
    for name in ("valid", "pix_h", "pix_w"):
        np.testing.assert_array_equal(getattr(active, name).numpy(),
                                      np.asarray(getattr(jactive, name)))
    similar = TF.find_similar_map_points(pc, tf[:, frame], active, DIST_TH, DOT_TH)
    jsimilar = JF.find_similar_map_points(jpc, jf[:, frame], jactive, DIST_TH, DOT_TH)
    np.testing.assert_array_equal(similar.numpy(), np.asarray(jsimilar))
    np.testing.assert_array_equal(winner.numpy(), np.asarray(jwinner))
    np.testing.assert_array_equal(corr.numpy(), np.asarray(jcorr))
    assert winner.sum() > 1000  # the frames overlap: most pixels correspond
    out = TF.fuse_with_map(pc, tf[:, frame], active, winner, corr, SIGMA)
    jout = JF.fuse_with_map(jpc, jf[:, frame], jactive, jwinner, jcorr, SIGMA)
    np.testing.assert_array_equal(out.num_points.numpy(), np.asarray(jout.num_points))
    np.testing.assert_array_equal(out.num_dropped.numpy(), np.asarray(jout.num_dropped))
    for name in ("points", "normals", "colors", "features"):
        # msrd's colours run 0-255: held within 1e-5 of their size
        rtol = MAP_ATOL if name == "colors" else 0.0
        np.testing.assert_allclose(getattr(out, name).numpy(), np.asarray(getattr(jout, name)),
                                   atol=MAP_ATOL, rtol=rtol, err_msg=name)


def test_fuse_with_map_appends_through_one_scatter_a_buffer(msrd_frames, monkeypatch):
    """The dense append is ``append_masked``: one ``scatter_rows_into`` call
    a buffer (points, normals, colors, features), the calls the kernel makes
    on the card; the correspondence chain makes none."""
    calls = []
    real = pointclouds_module._scatter_rows_into

    def spy(buf, dest, values):
        calls.append((tuple(buf.shape), tuple(values.shape)))
        return real(buf, dest, values)

    monkeypatch.setattr(pointclouds_module, "_scatter_rows_into", spy)

    def no_new_table(*args):
        raise AssertionError("the dense path made a new-table scatter")

    monkeypatch.setattr(pointclouds_module, "_scatter_rows", no_new_table)
    _, tf = msrd_frames
    cap, HW = 3 * 120 * 160, 120 * 160
    pc = Pointclouds.empty(2, cap, device="cpu")
    for s in range(3):
        active, winner, corr = TF.find_correspondences(pc, tf[:, s], DIST_TH, DOT_TH)
        assert len(calls) == 4 * s
        pc = TF.fuse_with_map(pc, tf[:, s], active, winner, corr, SIGMA)
        assert len(calls) == 4 * (s + 1)
    assert [c[1] for c in calls[:4]] == [(2, HW, 3)] * 3 + [(2, HW, 1)]
    assert all(c[0][:2] == (2, cap) for c in calls)


# --------------------------------------------------------------------- #
# The dense chain against the port's fast path
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("seed", [0, 1])
def test_dense_equals_sort_full_frame_by_frame(seed):
    rgb, depth, K, P = synthetic_sequence(2, 5, 48, 64, seed=seed)
    _, tf = both_frames(rgb, depth, K, P)
    pc = Pointclouds.empty(2, 3 * 48 * 64, device="cpu")
    for s in range(5):
        frame = tf[:, s]
        fast = TF.update_map_fusion(pc, frame, DIST_TH, DOT_TH, SIGMA, association="sort_full")
        active, winner, corr = TF.find_correspondences(pc, frame, DIST_TH, DOT_TH)
        dense = TF.fuse_with_map(pc, frame, active, winner, corr, SIGMA)
        assert torch.equal(fast.num_points, dense.num_points)
        assert torch.equal(fast.num_dropped, dense.num_dropped)
        for b in range(2):
            n = int(dense.num_points[b])
            for name in ("points", "normals", "colors", "features"):
                f, d = getattr(fast, name)[b, :n], getattr(dense, name)[b, :n]
                # row for row (both merge in place and append in pixel
                # order), and as JAX's test holds them: columns sorted
                torch.testing.assert_close(f, d, atol=MAP_ATOL, rtol=0)
                torch.testing.assert_close(torch.sort(f, dim=0).values,
                                           torch.sort(d, dim=0).values, atol=MAP_ATOL, rtol=0)
        mass = [float((m.features * m.nonpad_mask[..., None]).sum()) for m in (fast, dense)]
        np.testing.assert_allclose(mass[0], mass[1], rtol=1e-5)
        pc = dense
    assert (pc.num_points > 48 * 64).all()  # later frames appended new surface


# --------------------------------------------------------------------- #
# The whole msrd clip against the reference's maps
# --------------------------------------------------------------------- #
def _chamfer(a, b):
    from scipy.spatial import cKDTree

    da, _ = cKDTree(b).query(a)
    db, _ = cKDTree(a).query(b)
    return da.mean() + db.mean()


def test_dense_run_meets_the_reference_golden(msrd_frames):
    _, tf = msrd_frames
    pc = Pointclouds.empty(2, 3 * 120 * 160, device="cpu")
    for s in range(3):
        active, winner, corr = TF.find_correspondences(pc, tf[:, s], DIST_TH, DOT_TH)
        pc = TF.fuse_with_map(pc, tf[:, s], active, winner, corr, SIGMA)
    assert (pc.num_dropped == 0).all()
    for b in range(2):
        ref = golden(f"pointfusion_gt_points_{b}")
        ours = pc.points_list[b]
        assert abs(len(ours) - len(ref)) / len(ref) < 0.002
        assert _chamfer(ours, ref) < 1e-3
    np.testing.assert_allclose(pc.features_list[0].sum(),
                               golden("pointfusion_gt_ccounts_0").sum(), rtol=1e-4)
