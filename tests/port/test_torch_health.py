"""The port's tracking health (``gradslam_torch/slam/health.py``) held
against the JAX package on the CPU: the JAX tests' tracked 6-frame 60x80
hard clip (``tests/slam/test_health.py``), its map carried across, and the
last frame scored at its solved pose, at a corrupted pose and far outside
the map, by ``tracking_health`` (1-NN and projective), the window forms and
``keyframe_anchor``.

Tolerances: the same admissible counts; inlier fractions within 1/N (N the
rows counted: a residual at the band's edge may round to the other side);
medians within 1e-6; anchors' points and normals within 1e-6 with the same
counts."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import gradslam_tpu as G  # noqa: E402
import gradslam_torch as T  # noqa: E402
from gradslam_torch.odometry import icputils as TI  # noqa: E402
from gradslam_torch.odometry.projective import pack_frame_geom  # noqa: E402
from gradslam_torch.slam import health as TH  # noqa: E402
from gradslam_tpu.odometry import icputils as JI  # noqa: E402
from gradslam_tpu.slam import health as JH  # noqa: E402

from ._parity import both_frames, jax_map_to_torch  # noqa: E402

TUNED = dict(motion_model="constant_velocity", robust_loss="tukey",
             robust_scale=0.03, dist_thresh=0.01)
HEALTH_KW = dict(robust_scale=0.03, dist_thresh=0.01)


@pytest.fixture(scope="module")
def tracked_run():
    """The JAX test's run: its map (carried to the port) and the last frame
    in both packages."""
    B, L, H, W = 1, 6, 60, 80
    rgb, d, K, poses = T.hard_sequence(B, L, H, W, noise_sigma=0.003, outlier_frac=0.05)
    jf, tf = both_frames(rgb, d, K, poses)
    pf = G.PointFusion(odom="gradicp", dsratio=4, numiters=10, map_capacity=L * H * W, **TUNED)
    pc, op = pf(jf)
    return jf, tf, pc, jax_map_to_torch(pc), np.asarray(op), L


def _posed(jf, tf, L, pose):
    pose = np.array(pose, np.float32)[:, None]
    return (jf[:, L - 1].with_poses(jnp.asarray(pose)),
            tf[:, L - 1].with_poses(torch.from_numpy(pose)))


def _poses(op, L):
    """The solved pose, the JAX test's corrupted one (+0.25 m in x) and one
    far outside the map (+50 m)."""
    out = {"solved": op[:, L - 1]}
    for name, dx in (("corrupted", 0.25), ("gone", 50.0)):
        p = op[:, L - 1].copy()
        p[:, 0, 3] += dx
        out[name] = p
    return out


def _assert_fractions(ours, theirs, n_rows):
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=1.0 / n_rows + 1e-7,
                               rtol=0)


@pytest.mark.parametrize("method", ["knn", "projective"])
@pytest.mark.parametrize("which", ["solved", "corrupted", "gone"])
def test_tracking_health_matches_jax(tracked_run, method, which):
    jf, tf, jpc, tpc, op, L = tracked_run
    live_j, live_t = _posed(jf, tf, L, _poses(op, L)[which])
    kw = dict(HEALTH_KW, method=method)
    h_t = T.tracking_health(tpc, live_t, **kw)
    h_j = G.slam.tracking_health(jpc, live_j, **kw)
    # the rows the fractions count: the frame's stride-4 cloud (1-NN) or
    # the map window (projective)
    if method == "knn":
        n_rows = int(TI.downsample_rgbdimages(live_t, 4).num_points[0])
    else:
        window, _ = TH._map_window(tpc, live_t, 4, None)
        n_rows = max(int(window.num_points[0]), 1)
    for key in ("inlier_frac", "assoc_frac", "overlap_frac"):
        assert h_t[key].shape == (1,) and h_t[key].dtype == torch.float32
    assert round(float(h_t["assoc_frac"][0]) * n_rows) == round(
        float(h_j["assoc_frac"][0]) * n_rows)
    _assert_fractions(h_t["inlier_frac"], h_j["inlier_frac"], n_rows)
    np.testing.assert_allclose(h_t["overlap_frac"].numpy(), np.asarray(h_j["overlap_frac"]),
                               atol=1e-6, rtol=0)
    med_t, med_j = float(h_t["median_abs_residual"][0]), float(h_j["median_abs_residual"][0])
    assert np.isnan(med_t) == np.isnan(med_j)
    if not np.isnan(med_j):
        assert abs(med_t - med_j) <= 1e-6
    if which == "solved":
        assert float(h_t["inlier_frac"][0]) > 0.6
    if which == "gone":  # no map point in view: nothing is admissible
        assert float(h_t["inlier_frac"][0]) == 0.0 and float(h_t["assoc_frac"][0]) == 0.0


@pytest.mark.parametrize("which", ["solved", "corrupted"])
def test_window_health_forms_match_jax(tracked_run, which):
    """The in-scan gate's forms, against a window compacted once at the
    solved pose (the odometry's own finest window)."""
    jf, tf, jpc, tpc, op, L = tracked_run
    live_j, live_t = _posed(jf, tf, L, op[:, L - 1])
    window_t, _ = TH._map_window(tpc, live_t, 4, None)
    jtarget = G.Pointclouds(points=jpc.points, num_points=jpc.num_points, normals=jpc.normals)
    active = G.slam.fusionutils.find_active_map_points(jtarget, live_j)
    window_j = JI.downsample_pointclouds(jtarget, active.valid, active.pix_h, active.pix_w, 4,
                                         2 * 15 * 20)
    assert int(window_t.num_points[0]) == int(window_j.num_points[0])
    pose = _poses(op, L)[which]
    live_j, live_t = _posed(jf, tf, L, pose)
    n_rows = int(window_t.num_points[0])
    inl_t, ass_t = TH._window_health_projective(
        window_t, pack_frame_geom(live_t), live_t.intrinsics[:, 0], live_t.poses[:, 0], 60, 80,
        **HEALTH_KW)
    inl_j, ass_j = JH._window_health_projective(
        window_j, JH._pack_frame_geom(live_j), live_j.intrinsics[:, 0], live_j.poses[:, 0],
        60, 80, **HEALTH_KW)
    assert round(float(ass_t[0]) * n_rows) == round(float(ass_j[0]) * n_rows)
    _assert_fractions(inl_t, inl_j, n_rows)
    frames_t = TI.downsample_rgbdimages(live_t, 4)
    frames_j = JI.downsample_rgbdimages(live_j, 4)
    inl_t = TH._window_health_knn(frames_t, window_t, **HEALTH_KW)
    inl_j = JH._window_health_knn(frames_j, window_j, **HEALTH_KW)
    _assert_fractions(inl_t, inl_j, int(frames_t.num_points[0]))


@pytest.mark.parametrize("dsratio", [1, 3])
def test_keyframe_anchor_matches_jax(tracked_run, dsratio):
    jf, tf, _, _, op, L = tracked_run
    live_j, live_t = _posed(jf, tf, L, op[:, L - 1])
    a_t = T.keyframe_anchor(live_t, dsratio)
    a_j = G.slam.keyframe_anchor(live_j, dsratio)
    n = int(a_j.num_points[0])
    assert int(a_t.num_points[0]) == n and n > 0
    np.testing.assert_allclose(a_t.points[0, :n].numpy(), np.asarray(a_j.points[0, :n]),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(a_t.normals[0, :n].numpy(), np.asarray(a_j.normals[0, :n]),
                               atol=1e-6, rtol=0)
    assert bool((a_t.normals[0, :n].abs().sum(-1) > 0).all())  # zero normals dropped


@pytest.mark.parametrize("seed, n, keep", [(0, 9, 0.5), (1, 10, 0.6), (2, 7, 0.0), (3, 1, 1.0)])
def test_nanmedian_is_jax_nanmedian(seed, n, keep):
    """The median over the admissible rows interpolates between the two
    middle values for an even count, as ``jnp.nanmedian`` does; no row
    gives NaN."""
    rng = np.random.RandomState(seed)
    r = rng.rand(3, n).astype(np.float32)
    mask = rng.rand(3, n) < keep
    mask[0] = True
    ours = TH._nanmedian(torch.from_numpy(r), torch.from_numpy(mask)).numpy()
    theirs = np.asarray(jnp.nanmedian(jnp.where(jnp.asarray(mask), jnp.asarray(r), jnp.nan),
                                      axis=-1))
    np.testing.assert_array_equal(np.isnan(ours), np.isnan(theirs))
    np.testing.assert_allclose(ours[~np.isnan(ours)], theirs[~np.isnan(theirs)], rtol=1e-7)


@pytest.mark.parametrize("case", ["map_type", "frame_type", "no_normals", "no_poses", "method"])
def test_validation_matches_jax(tracked_run, case):
    jf, tf, jpc, tpc, op, L = tracked_run
    live_j, live_t = _posed(jf, tf, L, op[:, L - 1])
    args = {
        "map_type": ((live_t, live_t, {}), (live_j, live_j, {})),
        "frame_type": ((tpc, tpc, {}), (jpc, jpc, {})),
        "no_normals": ((dataclasses.replace(tpc, normals=None), live_t, {}),
                       (dataclasses.replace(jpc, normals=None), live_j, {})),
        "no_poses": ((tpc, dataclasses.replace(live_t, poses=None), {}),
                     (jpc, dataclasses.replace(live_j, poses=None), {})),
        "method": ((tpc, live_t, {"method": "icp"}), (jpc, live_j, {"method": "icp"})),
    }[case]
    errors = []
    for fn, (m, f, kw) in ((T.tracking_health, args[0]), (G.slam.tracking_health, args[1])):
        with pytest.raises((TypeError, ValueError)) as e:
            fn(m, f, **kw)
        errors.append(e.value)
    assert type(errors[0]) is type(errors[1])
    if case not in ("map_type", "frame_type"):  # the type names differ by package
        assert str(errors[0]) == str(errors[1])
