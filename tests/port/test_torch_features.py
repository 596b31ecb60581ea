"""User feature channels (semantic one-hots, descriptors) in the port, held
against the JAX package on the CPU: the frame's ``feature_image`` plane in
both layouts, PointFusion fusion in every association x merge x
color-layout combination on an overflowing window, the aggregate append,
``prune_map``, ``voxel_downsample`` and ``pointclouds_from_rgbdimages``
within 1e-5 of JAX (appends and compactions within 1e-6); both pipelines
with ``feature_channels`` on a 48x64x3 clip against JAX (poses 1e-5, counts
equal, map rows 1e-5); a map fused with features has the geometry, colors,
confidences and poses of the same run without them, bit for bit; and the
validation cases of ``tests/slam/test_feature_fusion.py``."""

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import gradslam_tpu as G  # noqa: E402
from gradslam_torch import ICPSLAM, PointFusion, Pointclouds, RGBDImages  # noqa: E402
from gradslam_torch.interop import rgbdimages_from_numpy, to_numpy  # noqa: E402
from gradslam_torch.slam import fusionutils as F  # noqa: E402
from gradslam_torch.structures import pointclouds_from_rgbdimages  # noqa: E402
from gradslam_tpu.datasets import synthetic_sequence  # noqa: E402
from gradslam_tpu.slam import fusionutils as JF  # noqa: E402
from gradslam_tpu.structures.utils import (  # noqa: E402
    pointclouds_from_rgbdimages as jax_pointclouds_from_rgbdimages,
)

from ._parity import jax_map_to_torch  # noqa: E402

DIST_TH, DOT_TH, SIGMA = 0.05, math.cos(math.radians(20)), 0.6
B, L, H, W = 2, 3, 48, 64
NF = 3


@pytest.fixture(autouse=True)
def deterministic():
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(before)


def _arrays(nf=NF, seed=1, holes=True):
    """A synthetic clip with 5% of its depths zeroed and a seeded feature
    plane: a one-hot of the pixel's column half (as the JAX tests), then
    continuous channels in [0, 1)."""
    rgb, depth, K, P = synthetic_sequence(B, L, H, W, seed=seed)
    rng = np.random.RandomState(seed)
    if holes:
        depth = depth * (rng.rand(*depth.shape) > 0.05).astype(np.float32)
    feat = rng.rand(B, L, H, W, nf).astype(np.float32)
    feat[..., :2] = 0.0
    feat[..., : W // 2, 0] = 1.0
    feat[..., W // 2:, 1] = 1.0
    return rgb, depth, K, P, feat


def _both(rgb, depth, K, P, feat):
    jf = G.RGBDImages(jnp.asarray(rgb), jnp.asarray(depth), jnp.asarray(K),
                      None if P is None else jnp.asarray(P),
                      feature_image=None if feat is None else jnp.asarray(feat))
    tf = rgbdimages_from_numpy(rgb, depth, K, P, feature_image=feat, device="cpu")
    return jf, tf


# --------------------------------------------------------------------------- #
# The frame's feature plane
# --------------------------------------------------------------------------- #
def test_feature_plane_layouts_and_indexing_match_jax():
    jf, tf = _both(*_arrays())
    assert tf.has_features and tf.feature_channels == NF
    cf, jcf = tf.to_channels_first(), jf.to_channels_first()
    assert cf.channels_first and tuple(cf.feature_image.shape) == (B, L, NF, H, W)
    assert cf.shape == (B, L, H, W) and cf.feature_channels == NF and cf.cdim == 2
    np.testing.assert_array_equal(cf.feature_image.numpy(), np.asarray(jcf.feature_image))
    for name in ("vertex_map", "normal_map", "global_vertex_map", "global_normal_map",
                 "pixel_pos", "valid_depth_mask"):
        np.testing.assert_allclose(getattr(cf, name).numpy().astype(np.float32),
                                   np.asarray(getattr(jcf, name)).astype(np.float32),
                                   atol=1e-6, rtol=0, err_msg=name)
    back = cf.to_channels_last_()
    assert not back.channels_first and torch.equal(back.feature_image, tf.feature_image)
    assert cf.to_channels_first_() is cf and tf.to_channels_last() is tf
    rt = RGBDImages.from_channels_first(cf.rgb_image, cf.depth_image, cf.intrinsics,
                                        cf.poses, feature_image=cf.feature_image)
    assert not rt.channels_first and torch.equal(rt.feature_image, tf.feature_image)
    one = tf[:, 1]
    assert tuple(one.feature_image.shape) == (B, 1, H, W, NF)
    np.testing.assert_array_equal(one.feature_image.numpy(), np.asarray(jf[:, 1].feature_image))
    assert torch.equal(tf[-1].feature_image, tf.feature_image[-1:])
    assert torch.equal(tf.with_poses(tf.poses * 2).feature_image, tf.feature_image)


def test_positional_channels_first_binds_as_in_jax():
    jf, tf = _both(*_arrays())
    cf = tf.to_channels_first()
    rt = RGBDImages(cf.rgb_image, cf.depth_image, cf.intrinsics, cf.poses, True)
    assert rt.channels_first and rt.feature_image is None and rt.normal_pitch == 1
    assert [f.name for f in dataclasses.fields(RGBDImages)] == [
        f.name for f in dataclasses.fields(G.RGBDImages)]


@pytest.mark.parametrize("bad", ["width", "rank", "layout"])
def test_bad_feature_plane_shapes_raise_as_in_jax(bad):
    rgb, depth, K, P, feat = _arrays()
    if bad == "width":
        feat = feat[:, :, :, :7]
    elif bad == "rank":
        feat = feat[0]
    else:  # a channels-first plane in a channels-last container
        feat = np.moveaxis(feat, -1, 2)
    with pytest.raises(ValueError, match="feature_image") as ours:
        rgbdimages_from_numpy(rgb, depth, K, P, feature_image=feat, device="cpu")
    with pytest.raises(ValueError, match="feature_image") as theirs:
        G.RGBDImages(jnp.asarray(rgb), jnp.asarray(depth), jnp.asarray(K), jnp.asarray(P),
                     feature_image=jnp.asarray(feat))
    assert str(ours.value).split(" Got")[0] == str(theirs.value).split(" Got")[0]


def test_channels_first_rgb_in_channels_last_container_raises():
    rgb, depth, K, P, _ = _arrays()
    with pytest.raises(ValueError, match="appears channels-first"):
        rgbdimages_from_numpy(np.moveaxis(rgb, -1, 2), depth, K, P, device="cpu")


@pytest.mark.parametrize("channels_first", [False, True], ids=["last", "first"])
def test_interop_round_trips_layout_and_plane(channels_first):
    rgb, depth, K, P, feat = _arrays()
    frames = rgbdimages_from_numpy(rgb, depth, K, P, feature_image=feat, device="cpu")
    if channels_first:
        frames = frames.to_channels_first()
    state = to_numpy(frames)
    assert state["channels_first"] is channels_first
    again = rgbdimages_from_numpy(**state, device="cpu")
    assert again.channels_first == channels_first
    for name in ("rgb_image", "depth_image", "intrinsics", "poses", "feature_image"):
        assert torch.equal(getattr(again, name), getattr(frames, name)), name


# --------------------------------------------------------------------------- #
# Fusion, aggregate, prune
# --------------------------------------------------------------------------- #
def _quantized(pc):
    """A JAX float-color feature map in the quantized layout ``[ccount,
    packed_color, *user]``, no colors."""
    feats = jnp.concatenate(
        [pc.features[..., :1], JF.pack_colors(pc.colors), pc.features[..., 1:]], axis=-1)
    return dataclasses.replace(pc, colors=None, features=feats)


@pytest.fixture(scope="module")
def overflowing():
    """Frames 0-1 fused by the JAX pipeline with ``feature_channels=3`` into
    capacity ``4 * H * W``, its first ``H * W`` rows copied behind it (the
    second half of the copies with 0.5 more confidence, so the default
    window overflows and the dropped copies would have won in
    ``sort_full``), and frame 2."""
    rgb, depth, K, P, feat = _arrays()
    HW = H * W
    jf, _ = _both(rgb[:, :2], depth[:, :2], K, P[:, :2], feat[:, :2])
    jmap, _ = G.PointFusion(odom="gt", feature_channels=NF, map_capacity=4 * HW)(jf)
    n = np.asarray(jmap.num_points)

    def dup(buf, bump=False):
        buf = np.array(buf)
        for b in range(B):
            copy = buf[b, :HW].copy()
            if bump:
                copy[HW // 2:, 0] += 0.5
            buf[b, n[b]:n[b] + HW] = copy
        return jnp.asarray(buf)

    big = G.Pointclouds(
        points=dup(jmap.points), num_points=jnp.asarray(n + HW), normals=dup(jmap.normals),
        colors=dup(jmap.colors), features=dup(jmap.features, bump=True),
        num_dropped=jmap.num_dropped,
    )
    live_j, live_t = _both(rgb[:, 2:], depth[:, 2:], K, P[:, 2:], feat[:, 2:])
    active = np.asarray(JF.find_active_map_points(big, live_j).valid).sum(-1)
    assert (active > 2 * HW).all(), active
    return big, live_j, live_t


def _assert_maps_agree(ours, theirs, atol):
    np.testing.assert_array_equal(ours.num_points.numpy(), np.asarray(theirs.num_points))
    for name in ("num_dropped", "points", "normals", "colors", "features"):
        o, t = getattr(ours, name), getattr(theirs, name)
        assert (o is None) == (t is None), name
        if o is None:
            continue
        o, t = o.numpy(), np.asarray(t)
        assert o.shape == t.shape, name
        if name == "features" and ours.colors is None:
            # the packed color may quantize one 8-bit step apart at a rounding
            # midpoint (the JAX CPU backend fuses multiply-adds)
            np.testing.assert_allclose(
                F.unpack_colors(torch.from_numpy(o[..., 1:2])).numpy(),
                np.asarray(JF.unpack_colors(jnp.asarray(t[..., 1:2]))),
                atol=1.0 / 255 + 1e-6, rtol=0, err_msg="packed colors")
            o, t = np.delete(o, 1, axis=-1), np.delete(t, 1, axis=-1)
        np.testing.assert_allclose(o, t, atol=atol, rtol=0, err_msg=name)


@pytest.mark.parametrize("quantized", [False, True], ids=["float", "quantized"])
@pytest.mark.parametrize("merge", ["gather", "scatter"])
@pytest.mark.parametrize("association", ["sort_full", "windowed"])
def test_feature_fusion_modes_match_jax(overflowing, association, merge, quantized):
    big, live_j, live_t = overflowing
    if quantized:
        big = _quantized(big)
    kw = dict(association=association, merge=merge)
    theirs = JF.update_map_fusion(big, live_j, DIST_TH, DOT_TH, SIGMA, **kw)
    ours = F.update_map_fusion(jax_map_to_torch(big), live_t, DIST_TH, DOT_TH, SIGMA, **kw)
    _assert_maps_agree(ours, theirs, atol=1e-5)


@pytest.mark.parametrize("quantized", [False, True], ids=["float", "quantized"])
@pytest.mark.parametrize("merge", ["gather", "scatter"])
@pytest.mark.parametrize("association", ["sort_full", "windowed"])
def test_features_do_not_change_the_fused_geometry(overflowing, association, merge, quantized):
    """Merge decisions never read user channels: the map fused with them
    and without them is the same in every other buffer, bit for bit."""
    big, _, live_t = overflowing
    if quantized:
        big = _quantized(big)
    base = 2 if quantized else 1
    kw = dict(association=association, merge=merge)
    with_f = F.update_map_fusion(jax_map_to_torch(big), live_t, DIST_TH, DOT_TH, SIGMA, **kw)
    plain_map = jax_map_to_torch(dataclasses.replace(big, features=big.features[..., :base]))
    plain_live = dataclasses.replace(live_t, feature_image=None)
    without = F.update_map_fusion(plain_map, plain_live, DIST_TH, DOT_TH, SIGMA, **kw)
    for name in ("points", "normals", "colors", "num_points", "num_dropped"):
        o, t = getattr(with_f, name), getattr(without, name)
        assert (o is None) == (t is None) and (o is None or torch.equal(o, t)), name
    assert torch.equal(with_f.features[..., :base], without.features)
    assert with_f.features.shape[-1] == base + NF


def test_weighted_average_hand_computed_as_in_jax():
    """One map point, one pixel landing on it: the fused user feature is
    ``(cc * f_map + alpha * f_frame) / (cc + alpha)``, as colors."""
    h = w = 4
    K = np.array([[10.0, 0, (w - 1) / 2, 0], [0, 10.0, (h - 1) / 2, 0], [0, 0, 1, 0],
                  [0, 0, 0, 1]], np.float32)[None, None]
    frames = rgbdimages_from_numpy(
        np.full((1, 1, h, w, 3), 0.5, np.float32), np.ones((1, 1, h, w, 1), np.float32), K,
        np.eye(4, dtype=np.float32)[None, None],
        feature_image=np.full((1, 1, h, w, 1), 2.0, np.float32), device="cpu")
    v, n = frames.vertex_map[0, 0, 1, 1], frames.global_normal_map[0, 0, 1, 1]
    cap, cc0, f0 = 8, 3.0, 8.0

    def first_row(row, width):
        buf = torch.zeros(1, cap, width)
        buf[0, 0] = row
        return buf

    pc = Pointclouds(points=first_row(v, 3), num_points=torch.tensor([1]),
                     normals=first_row(n, 3), colors=torch.zeros(1, cap, 3),
                     features=first_row(torch.tensor([cc0, f0]), 2),
                     num_dropped=torch.tensor([0]))
    out = F.update_map_fusion(pc, frames, 0.1, 0.5, 0.6)
    alpha = float(torch.clamp(torch.exp(-torch.sum(v**2) / (2 * 0.6**2)), 1e-7, 1.01))
    assert float(out.features[0, 0, 1]) == pytest.approx((cc0 * f0 + alpha * 2.0) / (cc0 + alpha),
                                                         rel=1e-5)
    assert float(out.features[0, 0, 0]) == pytest.approx(cc0 + alpha, rel=1e-5)


@pytest.mark.parametrize("n_user", [1, 4], ids=["missing", "wider"])
def test_fusion_width_mismatch_raises_as_in_jax(overflowing, n_user):
    big, live_j, live_t = overflowing
    if n_user == 1:  # the map carries user channels, the frame no plane
        live_j = dataclasses.replace(live_j, feature_image=None)
        live_t = dataclasses.replace(live_t, feature_image=None)
    else:
        big = dataclasses.replace(big, features=jnp.zeros(big.features.shape[:2] + (1 + n_user,)))
    with pytest.raises(ValueError) as theirs:
        JF.update_map_fusion(big, live_j, DIST_TH, DOT_TH, SIGMA)
    with pytest.raises(ValueError) as ours:
        F.update_map_fusion(jax_map_to_torch(big), live_t, DIST_TH, DOT_TH, SIGMA)
    for e in (ours.value, theirs.value):
        assert "feature_image" in str(e) and "user feature channel" in str(e)


@pytest.mark.parametrize("cap", [2 * H * W, H * W + 100], ids=["fits", "overflows"])
def test_aggregate_appends_user_features_like_jax(cap):
    rgb, depth, K, P, feat = _arrays()
    jf, tf = _both(rgb, depth, K, P, feat)
    jmap = G.Pointclouds.empty(B, cap, has_normals=True, has_colors=True, feature_dim=1 + NF)
    tmap = jax_map_to_torch(jmap)
    for i in range(2):
        jmap = JF.update_map_aggregate(jmap, jf[:, i])
        tmap = F.update_map_aggregate(tmap, tf[:, i])
        _assert_maps_agree(tmap, jmap, atol=1e-6)
    assert tmap.features.shape[-1] == 1 + NF
    n = int(tmap.num_points[0])
    np.testing.assert_allclose(tmap.features[0, :n, 1:3].sum(-1).numpy(), 1.0, atol=1e-6)


@pytest.mark.parametrize("feature_dim", [2, 1 + NF + 1], ids=["narrower", "wider"])
def test_aggregate_width_mismatch_raises_as_in_jax(feature_dim):
    jf, tf = _both(*_arrays())
    jmap = G.Pointclouds.empty(B, H * W, has_normals=True, has_colors=True,
                               feature_dim=feature_dim)
    with pytest.raises(ValueError, match="feature channel") as theirs:
        JF.update_map_aggregate(jmap, jf[:, 0])
    with pytest.raises(ValueError, match="feature channel") as ours:
        F.update_map_aggregate(jax_map_to_torch(jmap), tf[:, 0])
    assert f"{NF} channel(s)" in str(ours.value) and f"{NF} channel(s)" in str(theirs.value)


@pytest.mark.parametrize("quantized", [False, True], ids=["float", "quantized"])
@pytest.mark.parametrize("min_confidence", [0.03, 0.5])
def test_prune_wide_feature_map_matches_jax(overflowing, min_confidence, quantized):
    big = _quantized(overflowing[0]) if quantized else overflowing[0]
    theirs = JF.prune_map(big, min_confidence)
    ours = F.prune_map(jax_map_to_torch(big), min_confidence)
    _assert_maps_agree(ours, theirs, atol=0)
    assert 0 < int(ours.num_points[0]) < int(big.num_points[0])


# --------------------------------------------------------------------------- #
# voxel_downsample, pointclouds_from_rgbdimages, decode_map
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("layout", ["float", "quantized", "quantized_user", "bare"])
@pytest.mark.parametrize("reduce", ["mean", "first"])
def test_voxel_downsample_matches_jax(overflowing, layout, reduce):
    big = overflowing[0]
    flag = None
    if layout == "quantized":
        big = _quantized(dataclasses.replace(big, features=big.features[..., :1]))
    elif layout == "quantized_user":
        big, flag = _quantized(big), True
    elif layout == "bare":
        big = G.Pointclouds(points=big.points, num_points=big.num_points)
    theirs = JF.voxel_downsample(big, 0.02, reduce=reduce, quantized_colors=flag)
    ours = F.voxel_downsample(jax_map_to_torch(big), 0.02, reduce=reduce, quantized_colors=flag)
    _assert_maps_agree(ours, theirs, atol=1e-5)
    assert 0 < int(ours.num_points[0]) < int(big.num_points[0])
    if layout == "quantized_user":
        n = int(ours.num_points[0])
        np.testing.assert_allclose(ours.features[0, :n, 2:4].sum(-1).numpy(), 1.0, atol=1e-4)


@pytest.mark.parametrize("kw, match", [
    ({}, "cannot tell"),
    ({"quantized_colors": True, "float_colors": True}, "quantized_colors=True"),
    ({"voxel_size": 0.0}, "voxel_size"),
    ({"reduce": "median"}, "reduce"),
])
def test_voxel_downsample_refusals_match_jax(overflowing, kw, match):
    big = overflowing[0] if kw.pop("float_colors", False) else _quantized(overflowing[0])
    voxel = kw.pop("voxel_size", 0.02)
    with pytest.raises(ValueError, match=match):
        JF.voxel_downsample(big, voxel, **kw)
    with pytest.raises(ValueError, match=match):
        F.voxel_downsample(jax_map_to_torch(big), voxel, **kw)


@pytest.mark.parametrize("sigma", [None, 0.6])
@pytest.mark.parametrize("plane", [False, True])
def test_pointclouds_from_rgbdimages_matches_jax(sigma, plane):
    rgb, depth, K, P, feat = _arrays()
    jf, tf = _both(rgb[:, :1], depth[:, :1], K, P[:, :1], feat[:, :1] if plane else None)
    for kw in ({}, {"global_coordinates": False, "capacity": H * W // 2},
               {"filter_missing_depths": False}):
        theirs = jax_pointclouds_from_rgbdimages(jf, sigma=sigma, **kw)
        ours = pointclouds_from_rgbdimages(tf, sigma=sigma, **kw)
        _assert_maps_agree(ours, theirs, atol=1e-6)
    width = (0 if sigma is None else 1) + (NF if plane else 0)
    assert (ours.features is None) if width == 0 else ours.features.shape[-1] == width


def test_decode_map_keeps_user_features_as_jax():
    jf, tf = _both(*_arrays())
    kw = dict(odom="gt", feature_channels=NF, quantize_colors=True, map_capacity=L * H * W)
    jpc, _ = G.PointFusion(**kw)(jf)
    pc, _ = PointFusion(**kw)(tf)
    dec, jdec = PointFusion.decode_map(pc), G.PointFusion.decode_map(jpc)
    assert dec.features.shape[-1] == 1 + NF and dec.colors is not None
    np.testing.assert_array_equal(dec.features[..., 1:].numpy(), pc.features[..., 2:].numpy())
    _assert_maps_agree(dec, jdec, atol=1e-5)


# --------------------------------------------------------------------------- #
# Pipelines
# --------------------------------------------------------------------------- #
PIPELINES = {
    "gt": ("PointFusion", dict(odom="gt")),
    "gt_quantized": ("PointFusion", dict(odom="gt", quantize_colors=True)),
    "gt_windowed_scatter": ("PointFusion", dict(odom="gt", association="windowed",
                                                 merge="scatter", active_capacity=H * W)),
    "gt_prune": ("PointFusion", dict(odom="gt", prune_every=2, prune_min_confidence=0.5)),
    "tracked": ("PointFusion", dict(odom="gradicp", dsratio=4, numiters=3)),
    "icpslam_gt": ("ICPSLAM", dict(odom="gt")),
}


@pytest.mark.parametrize("name", list(PIPELINES))
def test_feature_pipeline_matches_jax(name):
    cls, kw = PIPELINES[name]
    kw = dict(kw, feature_channels=NF, map_capacity=L * H * W)
    jf, tf = _both(*_arrays())
    jpc, jposes = getattr(G, cls)(**kw)(jf)
    pc, poses = globals()[cls](**kw)(tf)
    np.testing.assert_allclose(poses.numpy(), np.asarray(jposes), atol=1e-5, rtol=0)
    _assert_maps_agree(pc, jpc, atol=1e-5)
    n = pc.num_points.tolist()
    base = pc.features.shape[-1] - NF
    for b in range(B):  # the one-hot half channels stay convex
        np.testing.assert_allclose(pc.features[b, :n[b], base:base + 2].sum(-1).numpy(), 1.0,
                                   atol=1e-5)


@pytest.mark.parametrize("name", list(PIPELINES))
def test_feature_pipeline_geometry_equals_featureless_run(name):
    cls, kw = PIPELINES[name]
    rgb, depth, K, P, feat = _arrays()
    runs = {}
    for nf, plane in ((0, None), (NF, feat)):
        frames = rgbdimages_from_numpy(rgb, depth, K, P, feature_image=plane, device="cpu")
        runs[nf] = globals()[cls](**kw, feature_channels=nf, map_capacity=L * H * W)(frames)
    (pc0, poses0), (pc, poses) = runs[0], runs[NF]
    assert torch.equal(poses, poses0)
    for field in ("points", "normals", "colors", "num_points", "num_dropped"):
        o, t = getattr(pc, field), getattr(pc0, field)
        assert (o is None) == (t is None) and (o is None or torch.equal(o, t)), field
    if pc0.features is not None:
        assert torch.equal(pc.features[..., :pc0.features.shape[-1]], pc0.features)


@pytest.mark.parametrize("cls", ["PointFusion", "ICPSLAM"])
@pytest.mark.parametrize("want, plane", [(0, True), (NF + 1, True), (NF, False)],
                         ids=["unwanted", "narrower", "missing"])
def test_forward_feature_width_mismatch_raises_as_in_jax(cls, want, plane):
    rgb, depth, K, P, feat = _arrays()
    jf, tf = _both(rgb, depth, K, P, feat if plane else None)
    with pytest.raises(ValueError, match="feature channel") as theirs:
        getattr(G, cls)(odom="gt", feature_channels=want)(jf)
    with pytest.raises(ValueError, match="feature channel") as ours:
        globals()[cls](odom="gt", feature_channels=want)(tf)
    got = NF if plane else 0
    for e in (ours.value, theirs.value):
        assert f"carry {got} feature channel(s) but this pipeline fuses {want}" in str(e)


def test_negative_feature_channels_raise():
    for cls in (PointFusion, ICPSLAM):
        with pytest.raises(ValueError, match="feature_channels"):
            cls(feature_channels=-1)


@pytest.mark.parametrize("merge", ["gather", "scatter"])
def test_gradients_to_the_feature_plane_match_jax(merge):
    rgb, depth, K, P, feat = _arrays()
    rgb, depth, P, feat = rgb[:, :2], depth[:, :2], P[:, :2], feat[:, :2]
    kw = dict(odom="gt", feature_channels=NF, merge=merge, map_capacity=2 * H * W)
    jf, tf = _both(rgb, depth, K, P, feat)

    def jloss(plane):
        pc, _ = G.PointFusion(**kw)(dataclasses.replace(jf, feature_image=plane))
        return jnp.sum(pc.features[..., 1:] ** 2)

    g_jax = np.asarray(jax.grad(jloss)(jnp.asarray(feat)))
    plane = torch.from_numpy(feat).requires_grad_(True)
    pc, _ = PointFusion(**kw)(dataclasses.replace(tf, feature_image=plane))
    torch.sum(pc.features[..., 1:] ** 2).backward()
    g = plane.grad.numpy()
    assert np.isfinite(g).all() and np.abs(g).sum() > 0
    np.testing.assert_allclose(g, g_jax, atol=1e-5 * np.abs(g_jax).max(), rtol=0)


def test_semantic_golden_holds_what_chip_smoke_reads():
    """The committed JAX CPU golden of the semantic slice was made from
    ``chip_smoke.py``'s rows, constants, stripe plane and stride-4 cloud, and
    carries the keys and shapes its ``semantic_online_phase`` reads."""
    import hashlib
    import importlib.util
    import json
    import os

    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(root, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    assert os.path.getsize(cs.SEM_GOLDEN) < 300_000
    data = np.load(cs.SEM_GOLDEN)
    assert json.loads(str(data["rows_json"])) == json.loads(json.dumps(cs.SEMANTIC_ROWS))
    assert json.loads(str(data["consts_json"])) == {
        "SEM_F": cs.SEM_F, "SEM_STRIPE_M": cs.SEM_STRIPE_M, "KNN_K": cs.KNN_K,
        "KNN_STRIDE": cs.KNN_STRIDE, "KNN_GOLDEN_NORMAL_ROWS": cs.KNN_GOLDEN_NORMAL_ROWS}
    for name, (_, shape, kw) in cs.SEMANTIC_ROWS.items():
        n = int(data[f"{name}_num_points"])
        assert int(data[f"{name}_num_dropped"]) == 0
        assert data[f"{name}_feature_sums"].shape == (cs.SEM_F,)
        assert data[f"{name}_class_hist"].shape == (cs.SEM_F,)
        assert int(data[f"{name}_class_hist"].sum()) == n
        np.testing.assert_allclose(data[f"{name}_feature_sums"].sum(), n, rtol=1e-6)
        if kw["odom"] != "gt":
            assert data[f"{name}_poses"].shape == (shape[1], 4, 4)
            assert data[f"{name}_ate_m"].shape == () and data[f"{name}_rpe"].shape == (2,)
    # the aggregate map appends every pixel: its classes are the stripe plane's
    _, shape, _ = cs.SEMANTIC_ROWS["icpslam_gt"]
    _, depth, K, P = synthetic_sequence(*shape, seed=0)
    np.testing.assert_array_equal(
        data["icpslam_gt_class_hist"],
        np.bincount(cs.stripe_classes(depth, K, P).ravel(), minlength=cs.SEM_F))
    _, depth, K, P = synthetic_sequence(*cs.SEMANTIC_ROWS["gt"][1], seed=0)
    pts = cs.stride_cloud(depth, K, P)
    assert str(data["knn_input_sha256"]) == hashlib.sha256(pts.tobytes()).hexdigest()
    N = pts.shape[1]
    assert data["knn_idx_delta"].shape == (N, cs.KNN_K)
    idx = data["knn_idx_delta"].astype(np.int64) + np.arange(N)[:, None]
    assert idx.min() >= 0 and idx.max() < N and (idx[:, 0] == np.arange(N)).mean() > 0.99
    assert data["knn_normals"].shape == (len(range(0, N, cs.KNN_GOLDEN_NORMAL_ROWS)), 3)
