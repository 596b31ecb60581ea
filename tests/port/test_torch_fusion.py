"""The port's PointFusion map update held against the JAX package on the
CPU. A map that the JAX pipeline built half-way through a clip is carried
across with ``gradslam_torch.interop``, then both sides fuse the same next
frame.

Tolerances: points within 1e-4 and normals within 1e-3 (the bars
``PARITY.md`` sets for maps); counts within 0.2% and confidence mass equal
to float32 summation error (rtol 1e-6). The association x merge x
color-layout combinations on an overflowing window: equal counts and every
buffer row within 1e-5, packed colors within one 8-bit step. ``pack_colors``/``unpack_colors`` exact;
``prune_map`` equal counts and rows within 1e-6. Every test runs under
``torch.use_deterministic_algorithms(True)``."""

import dataclasses
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


from ._threads import one_thread  # noqa: E402,F401


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
    ({"association": "bogus"}, ValueError),
    ({"merge": "bogus"}, ValueError),
    # a map with a user channel and a frame with no plane; the id keeps the
    # error this case raised before user channels were ported
    pytest.param({"features": 3}, ValueError, id="kw2-NotImplementedError"),
])
def test_unported_and_unknown_modes_raise(mid_sequence, kw, exc):
    jmap, _, live_t = mid_sequence
    tmap = jax_map_to_torch(jmap)
    match = None
    if "features" in kw:  # a user channel past [ccount, packed_color], no frame plane
        match = "no feature_image"
        tmap = dataclasses.replace(
            tmap, colors=None,
            features=torch.zeros(tmap.points.shape[:2] + (kw.pop("features"),)),
        )
    with pytest.raises(exc, match=match):
        F.update_map_fusion(tmap, live_t, DIST_TH, DOT_TH, SIGMA, **kw)


def _quantized(pc):
    """A JAX float-color map in the quantized layout: features
    ``[ccount, packed_color]``, no colors."""
    feats = jnp.concatenate([pc.features, JF.pack_colors(pc.colors)], axis=-1)
    return dataclasses.replace(pc, colors=None, features=feats)


@pytest.fixture(scope="module")
def overflowing():
    """The mid-sequence map grown to capacity ``4 * H * W`` with its first
    ``H * W`` rows copied behind it, the second half of the copies with 0.5
    more confidence: more than ``2 * H * W`` rows land in the frame, so the
    default window overflows, and the dropped copies would have won their
    pixels in ``sort_full``. Colors are scaled to [0, 1], the range the
    quantized layout packs."""
    m = msrd()
    m["colors"] = m["colors"] / np.float32(255.0)
    H, W = m["depths"].shape[2:4]
    HW = H * W
    jf, _ = both_frames(m["colors"][:, :2], m["depths"][:, :2], m["intrinsics"], m["poses"][:, :2])
    jmap, _ = G.PointFusion(odom="gt", map_capacity=4 * HW)(jf)
    n = np.asarray(jmap.num_points)

    def dup(buf, bump=None):
        buf = np.array(buf)
        for b in range(buf.shape[0]):
            copy = buf[b, :HW].copy()
            if bump is not None:
                copy[HW // 2:] += bump
            buf[b, n[b]:n[b] + HW] = copy
        return jnp.asarray(buf)

    big = G.Pointclouds(
        points=dup(jmap.points), num_points=jnp.asarray(n + HW),
        normals=dup(jmap.normals), colors=dup(jmap.colors),
        features=dup(jmap.features, bump=0.5), num_dropped=jmap.num_dropped,
    )
    live_j, live_t = both_frames(m["colors"][:, 2:3], m["depths"][:, 2:3], m["intrinsics"],
                                 m["poses"][:, 2:3])
    active = np.asarray(JF.find_active_map_points(big, live_j).valid).sum(-1)
    assert (active > 2 * HW).all(), active
    return big, live_j, live_t


def _assert_buffers_agree(ours, theirs, atol):
    np.testing.assert_array_equal(ours.num_points.numpy(), np.asarray(theirs.num_points))
    np.testing.assert_array_equal(ours.num_dropped.numpy(), np.asarray(theirs.num_dropped))
    for name in ("points", "normals", "colors", "features"):
        o, t = getattr(ours, name), getattr(theirs, name)
        assert (o is None) == (t is None), name
        if o is None:
            continue
        o, t = o.numpy(), np.asarray(t)
        if name == "features" and ours.colors is None:
            # a merged color that lies within an ulp of a rounding midpoint
            # may quantize one 8-bit step apart (the JAX CPU backend fuses
            # multiply-adds): compare the packed colors unpacked, to a step
            np.testing.assert_allclose(
                F.unpack_colors(torch.from_numpy(o[..., 1:2])).numpy(),
                np.asarray(JF.unpack_colors(jnp.asarray(t[..., 1:2]))),
                atol=1.0 / 255 + 1e-6, rtol=0, err_msg="packed colors")
            o, t = o[..., :1], t[..., :1]
        np.testing.assert_allclose(o, t, atol=atol, rtol=0, err_msg=name)


def test_auto_resolves_to_the_window_like_jax(overflowing):
    """Capacity 4 * H * W: JAX's 'auto' fuses with the 2 * H * W window,
    which overflows here, so 'auto' must pick it on both sides."""
    big, live_j, live_t = overflowing
    theirs = JF.update_map_fusion(big, live_j, DIST_TH, DOT_TH, SIGMA)
    ours = F.update_map_fusion(jax_map_to_torch(big), live_t, DIST_TH, DOT_TH, SIGMA)
    _assert_buffers_agree(ours, theirs, atol=1e-5)
    full = JF.update_map_fusion(big, live_j, DIST_TH, DOT_TH, SIGMA, association="sort_full")
    assert not np.array_equal(np.asarray(full.features), np.asarray(theirs.features))


@pytest.mark.parametrize("quantized", [False, True], ids=["float", "quantized"])
@pytest.mark.parametrize("merge", ["gather", "scatter", "auto"])
@pytest.mark.parametrize("association", ["sort_full", "windowed", "auto"])
def test_fusion_modes_match_jax(overflowing, association, merge, quantized):
    big, live_j, live_t = overflowing
    if quantized:
        big = _quantized(big)
    kw = dict(association=association, merge=merge)
    theirs = JF.update_map_fusion(big, live_j, DIST_TH, DOT_TH, SIGMA, **kw)
    ours = F.update_map_fusion(jax_map_to_torch(big), live_t, DIST_TH, DOT_TH, SIGMA, **kw)
    _assert_buffers_agree(ours, theirs, atol=1e-5)


@pytest.mark.parametrize("cap_hw, active_capacity, expect", [
    (3, None, ("sort_full", "gather")),
    (4, None, ("windowed", "gather")),
    (4, 5, ("sort_full", "gather")),
    (7, None, ("windowed", "scatter")),
    (7, 3, ("windowed", "scatter")),
])
def test_auto_resolution_follows_jax(cap_hw, active_capacity, expect):
    HW = 100
    window = min(active_capacity * HW if active_capacity else 2 * HW, cap_hw * HW)
    assert F._resolve_modes("auto", "auto", cap_hw * HW, HW, window) == expect


def test_pack_colors_round_trip_matches_jax():
    rng = np.random.RandomState(3)
    colors = rng.rand(4, 500, 3).astype(np.float32)
    colors[0, :6] = [[0, 0, 0], [1, 1, 1], [0.5 / 255, 1.5 / 255, 2.5 / 255],
                     [-0.1, 1.2, 0.5], [127.5 / 255] * 3, [254.5 / 255] * 3]
    ours = F.pack_colors(torch.from_numpy(colors))
    theirs = np.asarray(JF.pack_colors(jnp.asarray(colors)))
    np.testing.assert_array_equal(ours.numpy(), theirs)
    assert ours.dtype == torch.float32 and float(ours.max()) <= 2**24 - 1
    np.testing.assert_array_equal(F.unpack_colors(ours).numpy(),
                                  np.asarray(JF.unpack_colors(jnp.asarray(theirs))))


@pytest.mark.parametrize("min_confidence", [0.5, 1.5, 100.0])
def test_prune_map_matches_jax(mid_sequence, min_confidence):
    jmap, live_j, live_t = mid_sequence
    theirs = JF.prune_map(jmap, min_confidence)
    ours = F.prune_map(jax_map_to_torch(jmap), min_confidence)
    _assert_buffers_agree(ours, theirs, atol=1e-6)
    qmap = _quantized(jmap)
    _assert_buffers_agree(F.prune_map(jax_map_to_torch(qmap), min_confidence),
                          JF.prune_map(qmap, min_confidence), atol=1e-6)
