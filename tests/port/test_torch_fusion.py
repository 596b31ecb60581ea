"""The port's PointFusion map update held against the JAX package on the
CPU. A map that the JAX pipeline built half-way through a clip is carried
across with ``gradslam_torch.interop``, then both sides fuse the same next
frame.

Tolerances: points within 1e-4 and normals within 1e-3 (the bars
``PARITY.md`` sets for maps); counts within 0.2% and confidence mass equal
to float32 summation error (rtol 1e-6). Every test runs under
``torch.use_deterministic_algorithms(True)``."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import gradslam_tpu as G  # noqa: E402
from gradslam_torch.slam import fusionutils as F  # noqa: E402
from gradslam_tpu.slam import fusionutils as JF  # noqa: E402

from ._parity import both_frames, jax_map_to_torch, msrd  # noqa: E402

DIST_TH, DOT_TH, SIGMA = 0.05, math.cos(math.radians(20)), 0.6


@pytest.fixture(autouse=True)
def deterministic():
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(before)


@pytest.fixture(scope="module")
def mid_sequence():
    """msrd frames 0-1 fused by the JAX pipeline into a map of capacity
    ``3 * H * W``, and frame 2 with its pose nudged by 4 mm and 0.3 degrees,
    so that some map rows fail the distance and normal gates."""
    m = msrd()
    H, W = m["depths"].shape[2:4]
    jf, _ = both_frames(m["colors"][:, :2], m["depths"][:, :2], m["intrinsics"], m["poses"][:, :2])
    jmap, _ = G.PointFusion(odom="gt", map_capacity=3 * H * W)(jf)
    nudge = np.asarray(G.se3_exp(jnp.asarray([0.004, -0.002, 0.001, 0.005, 0.0, -0.003])))
    poses = m["poses"][:, 2:3] @ nudge
    live_j, live_t = both_frames(m["colors"][:, 2:3], m["depths"][:, 2:3], m["intrinsics"], poses)
    return jmap, live_j, live_t


def _fuse_both(jmap, live_j, live_t, **kw):
    theirs = JF.update_map_fusion(jmap, live_j, DIST_TH, DOT_TH, SIGMA, **kw)
    ours = F.update_map_fusion(jax_map_to_torch(jmap), live_t, DIST_TH, DOT_TH, SIGMA, **kw)
    return ours, theirs


def _assert_maps_agree(ours, theirs):
    n_t = np.asarray(theirs.num_points)
    n_o = ours.num_points.numpy()
    assert (np.abs(n_o - n_t) <= 0.002 * n_t).all(), (n_o, n_t)
    np.testing.assert_array_equal(ours.num_dropped.numpy(), np.asarray(theirs.num_dropped))
    for b in range(len(n_t)):
        n = min(n_o[b], n_t[b])
        pts_o, pts_t = ours.points_list[b][:n], theirs.points_list[b][:n]
        np.testing.assert_allclose(pts_o, pts_t, atol=1e-4, rtol=0)
        np.testing.assert_allclose(ours.normals_list[b][:n], theirs.normals_list[b][:n],
                                   atol=1e-3, rtol=0)
        np.testing.assert_allclose(ours.colors_list[b][:n], theirs.colors_list[b][:n],
                                   atol=1e-4, rtol=0)
        np.testing.assert_allclose(ours.features_list[b].sum(),
                                   np.asarray(theirs.features_list[b]).sum(), rtol=1e-6)


def test_one_fusion_step_from_shared_map_matches_jax(mid_sequence):
    jmap, live_j, live_t = mid_sequence
    ours, theirs = _fuse_both(jmap, live_j, live_t)
    # the step both merged into old rows and appended new ones
    assert (ours.num_points > jax_map_to_torch(jmap).num_points).all()
    _assert_maps_agree(ours, theirs)
    # the untouched padding stays zero
    n = int(ours.num_points.max())
    assert (ours.points[:, n:] == 0).all()


def test_fusion_overflow_counts_dropped_like_jax(mid_sequence):
    jmap, live_j, live_t = mid_sequence
    # room for only 500 more points: the rest of the appends are dropped
    n0 = int(np.asarray(jmap.num_points).max())
    small = G.Pointclouds(
        points=jmap.points[:, : n0 + 500], num_points=jmap.num_points,
        normals=jmap.normals[:, : n0 + 500], colors=jmap.colors[:, : n0 + 500],
        features=jmap.features[:, : n0 + 500], num_dropped=jmap.num_dropped,
    )
    ours, theirs = _fuse_both(small, live_j, live_t)
    assert (ours.num_dropped > 0).all()
    assert (ours.num_points <= n0 + 500).all()
    _assert_maps_agree(ours, theirs)


def test_duplicate_map_rows_tie_break_like_jax(mid_sequence):
    """Exact copies of map rows tie on (pixel, ccount, raydist): the lowest
    row index must win, as in the JAX sort's index key. Some copies get a
    larger ccount and must win over their originals instead."""
    jmap, live_j, live_t = mid_sequence
    n = np.asarray(jmap.num_points)
    k = 2000

    def dup(buf, bump=None):
        buf = np.array(buf)
        for b in range(buf.shape[0]):
            copy = buf[b, :k].copy()
            if bump is not None:
                copy[k // 2:] += bump
            buf[b, n[b]:n[b] + k] = copy
        return jnp.asarray(buf)

    dmap = G.Pointclouds(
        points=dup(jmap.points), num_points=jnp.asarray(n + k),
        normals=dup(jmap.normals), colors=dup(jmap.colors),
        features=dup(jmap.features, bump=0.5), num_dropped=jmap.num_dropped,
    )
    ours, theirs = _fuse_both(dmap, live_j, live_t)
    np.testing.assert_array_equal(ours.num_points.numpy(), np.asarray(theirs.num_points))
    np.testing.assert_allclose(ours.points.numpy(), np.asarray(theirs.points), atol=1e-5, rtol=0)
    np.testing.assert_allclose(ours.features.numpy(), np.asarray(theirs.features),
                               atol=1e-5, rtol=0)


def test_lexsort_matches_numpy():
    rng = np.random.RandomState(0)
    keys = [rng.randint(0, 4, (2, 300)).astype(np.float32) for _ in range(3)]
    keys[0][:, ::7] = np.inf
    order = F._lexsort([torch.from_numpy(k) for k in keys])
    for b in range(2):
        # np.lexsort: last key most significant; ties by index (stable)
        expect = np.lexsort([np.arange(300)] + [k[b] for k in keys])
        np.testing.assert_array_equal(order[b].numpy(), expect)


def test_active_map_points_and_alpha_match_jax(mid_sequence):
    jmap, live_j, live_t = mid_sequence
    ours = F.find_active_map_points(jax_map_to_torch(jmap), live_t)
    theirs = JF.find_active_map_points(jmap, live_j)
    for name in ("valid", "pix_h", "pix_w"):
        np.testing.assert_array_equal(getattr(ours, name).numpy(),
                                      np.asarray(getattr(theirs, name)))
    vm = live_t.vertex_map
    np.testing.assert_allclose(
        F.get_alpha(vm, SIGMA, dim=4, keepdim=True).numpy(),
        np.asarray(JF.get_alpha(live_j.vertex_map, SIGMA, dim=4, keepdim=True)),
        atol=1e-6, rtol=0,
    )
    # the eps floor of the confidence
    a = F.get_alpha(torch.tensor([[0.0, 0.0, 0.0], [1e3, 0.0, 0.0]]), 0.6)
    assert a.tolist() == pytest.approx([1.0, 1e-7])


def test_pixel_snap_is_round_half_to_even():
    snapped = F._snap(torch.tensor([0.5, 1.5, 2.5, -0.4, 9.6]), 10)
    assert snapped.tolist() == [0, 2, 2, 0, 9]


@pytest.mark.parametrize("kw, exc", [
    ({"association": "windowed"}, NotImplementedError),
    ({"merge": "scatter"}, NotImplementedError),
    ({"association": "bogus"}, ValueError),
    ({"merge": "bogus"}, ValueError),
])
def test_unported_and_unknown_modes_raise(mid_sequence, kw, exc):
    jmap, _, live_t = mid_sequence
    with pytest.raises(exc):
        F.update_map_fusion(jax_map_to_torch(jmap), live_t, DIST_TH, DOT_TH, SIGMA, **kw)
