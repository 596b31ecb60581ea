"""The online API of the port (``ICPSLAM.step``, ``localize``,
``map_update``) and ``GroundTruthOdometryProvider``, held against the JAX
package on the CPU (poses within 1e-5, map counts equal, map points within
1e-5), and against the port's own ``forward``: a step loop at the
forward's fixed ``map_capacity`` runs the same per-frame body, so its poses
and map are the forward's bit for bit, and ``localize`` followed by
``map_update`` is ``step`` bit for bit. ``Pointclouds.empty`` lands on the
card unless asked for another device."""

import dataclasses
import inspect
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import gradslam_tpu as G  # noqa: E402
from gradslam_torch import (  # noqa: E402
    ICPSLAM,
    GroundTruthOdometryProvider,
    PointFusion,
    Pointclouds,
    compose_transformations,
    inverse_transformation,
)
from gradslam_torch.interop import rgbdimages_from_numpy  # noqa: E402
from gradslam_tpu.datasets import synthetic_sequence  # noqa: E402

from ._parity import jax_map_to_torch  # noqa: E402

L, H, W = 4, 48, 64
CAP = L * H * W


def _arrays(B=1, speed=2.0, feature_channels=0, seed=0):
    rgb, depth, K, P = synthetic_sequence(B, L, H, W, seed=seed, speed=speed)
    feat = None
    if feature_channels:
        feat = np.random.RandomState(seed).rand(B, L, H, W, feature_channels).astype(np.float32)
    return rgb, depth, K, P, feat


def _both(rgb, depth, K, P, feat=None):
    jf = G.RGBDImages(jnp.asarray(rgb), jnp.asarray(depth), jnp.asarray(K), jnp.asarray(P),
                      feature_image=None if feat is None else jnp.asarray(feat))
    tf = rgbdimages_from_numpy(rgb, depth, K, P, feature_image=feat, device="cpu")
    return jf, tf


def _eye(B, like):
    if isinstance(like, torch.Tensor):
        return torch.eye(4, dtype=like.dtype).expand(B, 4, 4)
    return jnp.broadcast_to(jnp.eye(4, dtype=like.dtype), (B, 4, 4))


def _step_loop(slam, frames, empty, cv=False, split=False, jax_side=False):
    """The online loop of ``examples/online_slam.py``: frame 0 bootstraps at
    its own pose, each later frame is tracked from the previous returned
    pose; with ``cv`` the motion of the previous step is threaded as
    ``prev_transform`` (the identity on the first tracked frame); with
    ``split`` each step is ``localize`` then ``map_update``."""
    compose = G.compose_transformations if jax_side else compose_transformations
    inverse = G.inverse_transformation if jax_side else inverse_transformation
    B = frames.shape[0]
    pc, pose = slam.step(empty, frames[:, 0])
    poses = [pose[:, 0]]
    delta = _eye(B, pose) if cv else None
    for s in range(1, frames.shape[1]):
        prev = None if slam.odom == "gt" else frames[:, s - 1].with_poses(poses[-1][:, None])
        live = frames[:, s]
        if split:
            pose = slam.localize(pc, live, prev, prev_transform=delta)
            pc = slam.map_update(pc, live.with_poses(pose))
        else:
            pc, pose = slam.step(pc, live, prev, prev_transform=delta)
        if cv:
            delta = compose(pose[:, 0], inverse(poses[-1]))
        poses.append(pose[:, 0])
    stack = jnp.stack if jax_side else torch.stack
    return pc, stack(poses, 1)


def _assert_bit_equal(a, b):
    (pa, ta), (pb, tb) = a, b
    assert torch.equal(ta, tb)
    for name in ("points", "normals", "colors", "features", "num_points", "num_dropped"):
        x, y = getattr(pa, name), getattr(pb, name)
        assert (x is None) == (y is None) and (x is None or torch.equal(x, y)), name


ONLINE = {
    "gt": ("PointFusion", dict(odom="gt"), False),
    "gt_features_quantized": ("PointFusion", dict(odom="gt", feature_channels=2,
                                                  quantize_colors=True), False),
    "gt_windowed_scatter": ("PointFusion", dict(odom="gt", association="windowed",
                                                merge="scatter", active_capacity=H * W), False),
    "gradicp": ("PointFusion", dict(odom="gradicp", dsratio=4, numiters=3), False),
    "gradicp_cv": ("PointFusion", dict(odom="gradicp", dsratio=4, numiters=3,
                                       motion_model="constant_velocity"), True),
    "projective_features": ("PointFusion", dict(odom="gradicp", odom_assoc="projective",
                                                dsratio=2, numiters=3, feature_channels=2),
                            False),
    "icpslam_pyramid": ("ICPSLAM", dict(odom="icp", pyramid=[(2, 3)]), False),
    "icpslam_gt_features": ("ICPSLAM", dict(odom="gt", feature_channels=2), False),
}


def _pipeline(name, package):
    cls, kw, cv = ONLINE[name]
    ns = G if package == "jax" else globals()
    return getattr(ns, cls) if package == "jax" else ns[cls], dict(kw, map_capacity=CAP), cv


@pytest.mark.parametrize("name", list(ONLINE))
def test_step_loop_equals_forward(name):
    """At a fixed capacity the step loop runs the forward's per-frame body
    on the same inputs: the same bits."""
    cls, kw, cv = _pipeline(name, "torch")
    _, tf = _both(*_arrays(B=2, feature_channels=kw.get("feature_channels", 0)))
    slam = cls(**kw)
    fwd = slam(tf)
    online = _step_loop(slam, tf, slam.empty_map(2, CAP, device="cpu"), cv=cv)
    _assert_bit_equal(online, fwd)


@pytest.mark.parametrize("name", [n for n in ONLINE if ONLINE[n][1]["odom"] != "gt"])
def test_localize_then_map_update_equals_step(name):
    cls, kw, cv = _pipeline(name, "torch")
    _, tf = _both(*_arrays(B=2, feature_channels=kw.get("feature_channels", 0)))
    slam = cls(**kw)
    empty = slam.empty_map(2, CAP, device="cpu")
    _assert_bit_equal(_step_loop(slam, tf, empty, cv=cv, split=True),
                      _step_loop(slam, tf, empty, cv=cv))


@pytest.mark.parametrize("name", list(ONLINE))
def test_step_loop_matches_jax(name):
    cls, kw, cv = _pipeline(name, "torch")
    jcls, _, _ = _pipeline(name, "jax")
    jf, tf = _both(*_arrays(B=2, feature_channels=kw.get("feature_channels", 0)))
    jslam, slam = jcls(**kw), cls(**kw)
    jpc, jposes = _step_loop(jslam, jf, jslam.empty_map(2, CAP), cv=cv, jax_side=True)
    pc, poses = _step_loop(slam, tf, slam.empty_map(2, CAP, device="cpu"), cv=cv)
    np.testing.assert_allclose(poses.numpy(), np.asarray(jposes), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(pc.num_points.numpy(), np.asarray(jpc.num_points))
    n = pc.num_points.tolist()
    for b in range(2):
        np.testing.assert_allclose(pc.points[b, :n[b]].numpy(), np.asarray(jpc.points[b, :n[b]]),
                                   atol=1e-5, rtol=0)
        if pc.features is not None:  # a packed color may round one 8-bit step apart
            keep = [c for c in range(pc.features.shape[-1]) if pc.colors is not None or c != 1]
            np.testing.assert_allclose(pc.features[b, :n[b], keep].numpy(),
                                       np.asarray(jpc.features[b, :n[b]])[:, keep],
                                       atol=1e-5, rtol=0)


@pytest.mark.parametrize("cv", [False, True], ids=["static", "prev_transform"])
def test_localize_and_map_update_match_jax_from_the_same_map(cv):
    """Both packages start from the JAX map of frames 0-2 and solve frame 3
    (from frame 2's pose, and with the motion 1 -> 2 as the prior)."""
    kw = dict(odom="gradicp", dsratio=4, numiters=5, map_capacity=CAP)
    jf, tf = _both(*_arrays(B=2, speed=4.0))
    jslam, slam = G.PointFusion(**kw), PointFusion(**kw)
    jmap, _ = G.PointFusion(odom="gt", map_capacity=CAP)(jf[:, :3])
    delta = None
    if cv:
        delta = np.array(G.compose_transformations(jf.poses[:, 2],
                                                     G.inverse_transformation(jf.poses[:, 1])))
    jpose = jslam.localize(jmap, jf[:, 3], jf[:, 2],
                           prev_transform=None if delta is None else jnp.asarray(delta))
    pose = slam.localize(jax_map_to_torch(jmap), tf[:, 3], tf[:, 2],
                         prev_transform=None if delta is None else torch.from_numpy(delta))
    assert tuple(pose.shape) == (2, 1, 4, 4)
    np.testing.assert_allclose(pose.numpy(), np.asarray(jpose), atol=1e-5, rtol=0)
    jnew = jslam.map_update(jmap, jf[:, 3].with_poses(jpose))
    new = slam.map_update(jax_map_to_torch(jmap), tf[:, 3].with_poses(pose))
    np.testing.assert_array_equal(new.num_points.numpy(), np.asarray(jnew.num_points))


def test_prev_transform_replays_the_constant_velocity_forward():
    """JAX's ``test_step_prev_transform_replays_forward`` at 48x64x4 with a
    fast pan: in the port bit for bit, against JAX within 1e-5."""
    kw = dict(odom="icp", dsratio=2, numiters=3, motion_model="constant_velocity",
              map_capacity=CAP)
    jf, tf = _both(*_arrays(speed=8.0))
    slam, jslam = ICPSLAM(**kw), G.ICPSLAM(**kw)
    fwd = slam(tf)
    online = _step_loop(slam, tf, slam.empty_map(1, CAP, device="cpu"), cv=True)
    _assert_bit_equal(online, fwd)
    jpc, jposes = _step_loop(jslam, jf, jslam.empty_map(1, CAP), cv=True, jax_side=True)
    np.testing.assert_allclose(online[1].numpy(), np.asarray(jposes), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(online[0].num_points.numpy(), np.asarray(jpc.num_points))
    # without the prior the solves start elsewhere
    static = _step_loop(slam, tf, slam.empty_map(1, CAP, device="cpu"), cv=False)
    assert not torch.equal(static[1], online[1])


def test_prev_transform_shape_is_checked_as_in_jax():
    jf, tf = _both(*_arrays(B=2))
    slam, jslam = PointFusion(odom="gradicp", dsratio=4, numiters=2), G.PointFusion(
        odom="gradicp", dsratio=4, numiters=2)
    pc = slam.empty_map(2, CAP, device="cpu")
    bad = torch.eye(4).expand(2, 1, 4, 4)
    for call in (lambda: slam.step(pc, tf[:, 1], tf[:, 0], prev_transform=bad),
                 lambda: slam.localize(pc, tf[:, 1], tf[:, 0], prev_transform=bad)):
        with pytest.raises(ValueError, match=r"prev_transform must have shape \(B, 4, 4\)"):
            call()
    with pytest.raises(ValueError, match=r"prev_transform must have shape \(B, 4, 4\)"):
        jslam.step(jslam.empty_map(2, CAP), jf[:, 1], jf[:, 0],
                   prev_transform=jnp.asarray(bad.numpy()))


def test_step_warns_on_misused_prev_frame_as_jax():
    """A forgotten ``prev_frame`` with tracking warns once the map holds
    points (frame 0's bootstrap does not); ``odom='gt'`` with a
    ``prev_frame`` warns that it is unused."""
    _, tf = _both(*_arrays())
    slam = PointFusion(odom="gradicp", dsratio=2, numiters=2)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        pc, _ = slam.step(slam.empty_map(1, CAP, device="cpu"), tf[:, 0])
    with pytest.warns(UserWarning, match="prev_frame.*was None"):
        slam.step(pc, tf[:, 1])
    gt = PointFusion(odom="gt")
    with pytest.warns(UserWarning, match="not used"):
        gt.step(gt.empty_map(1, CAP, device="cpu"), tf[:, 1], tf[:, 0])


@pytest.mark.parametrize("case", ["gt_localize", "no_poses", "prev_without_poses",
                                  "not_frames", "width"])
def test_online_refusals_match_jax(case):
    jf, tf = _both(*_arrays())
    odom = "gt" if case == "gt_localize" else "gradicp"
    kw = dict(odom=odom, map_capacity=CAP)
    sides = [(G.PointFusion(**kw), jf, lambda s: s.empty_map(1, CAP)),
             (PointFusion(**kw), tf, lambda s: s.empty_map(1, CAP, device="cpu"))]
    for slam, frames, empty in sides:
        pc = empty(slam)
        live, prev = frames[:, 1], frames[:, 0]
        if case == "gt_localize":
            call, exc, match = lambda: slam.localize(pc, live, prev), ValueError, "localize"
        elif case == "no_poses":
            call = lambda: slam.step(pc, dataclasses.replace(live, poses=None))  # noqa: E731
            exc, match = ValueError, "must have poses"
        elif case == "prev_without_poses":
            call = lambda: slam.step(pc, live, dataclasses.replace(prev, poses=None))  # noqa: E731
            exc, match = ValueError, "should have poses"
        elif case == "not_frames":
            call, exc, match = lambda: slam.step(pc, live.rgb_image), TypeError, "live_frame"
        else:
            with_plane = dataclasses.replace(live, feature_image=live.rgb_image[..., :2])
            call = lambda: slam.step(pc, with_plane)  # noqa: E731
            exc, match = ValueError, "2 feature channel"
        with pytest.raises(exc, match=match):
            call()


def test_step_under_remat_gives_the_same_bits():
    _, tf = _both(*_arrays())
    kw = dict(odom="gradicp", dsratio=4, numiters=3, map_capacity=CAP)
    runs = [_step_loop(PointFusion(**kw, remat=remat), tf,
                       PointFusion(**kw).empty_map(1, CAP, device="cpu")) for remat in (0, 1)]
    _assert_bit_equal(*runs)


def test_groundtruth_provider_matches_jax():
    jf, tf = _both(*_arrays(B=2))
    theirs = G.GroundTruthOdometryProvider().provide(jf[:, 0], jf[:, 2])
    ours = GroundTruthOdometryProvider().provide(tf[:, 0], tf[:, 2])
    assert tuple(ours.shape) == (2, 1, 4, 4)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=1e-6, rtol=0)
    # composing it onto frame 0's pose gives frame 2's
    np.testing.assert_allclose(torch.matmul(tf.poses[:, 0:1], ours).numpy(),
                               tf.poses[:, 2:3].numpy(), atol=1e-5, rtol=0)
    prov = GroundTruthOdometryProvider()
    with pytest.raises(TypeError):
        prov.provide(tf[:, 0], tf.poses)
    with pytest.raises(ValueError, match="sequence length of 1"):
        prov.provide(tf[:, 0:2], tf[:, 2])
    with pytest.raises(ValueError, match="Batch sizes"):
        prov.provide(tf[0:1, 0], tf[:, 2])
    with pytest.raises(ValueError, match="must have poses"):
        prov.provide(tf[:, 0], dataclasses.replace(tf[:, 2], poses=None))


def test_pointclouds_empty_defaults_to_the_card():
    """JAX's online tests start from ``Pointclouds.empty(2, cap)``: the
    port's needs no device either, and lands on the card; on a machine
    without one the call raises."""
    assert inspect.signature(Pointclouds.empty).parameters["device"].default == "cuda"
    cpu = Pointclouds.empty(2, 16, device="cpu")
    assert cpu.points.device.type == "cpu" and tuple(cpu.points.shape) == (2, 16, 3)
    assert cpu.features.shape[-1] == 1 and int(cpu.num_dropped.sum()) == 0
    if torch.cuda.is_available():
        assert Pointclouds.empty(2, 16).points.is_cuda
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            Pointclouds.empty(2, 16)
