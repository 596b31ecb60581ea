"""Geometry and RGB-D derived maps of the port held against the JAX package
on the CPU, on the same numpy inputs, and against the reference goldens in
``tests/data/msrd_b2s3``.

Tolerances: transforms and twists within 1e-6 (float32, a handful of
operations in another order); vertex maps within 1e-4 and normals within
1e-3, the bars ``PARITY.md`` records for the reference goldens."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import gradslam_tpu as G  # noqa: E402
import gradslam_torch.geometry as T  # noqa: E402
from gradslam_torch.datasets import synthetic_sequence  # noqa: E402

from ._parity import both_frames, msrd, rigid_transforms  # noqa: E402

ATOL = 1e-6


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _close(ours, theirs, atol=ATOL):
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(theirs), atol=atol, rtol=0)


def _twists(seed):
    """Random twists plus the small-angle branch's edge: exact zeros and
    rotations far below the 1e-6 switch."""
    rng = np.random.RandomState(seed)
    xi = rng.randn(16, 6).astype(np.float32)
    xi[3:6, 3:] = 0.0
    xi[6:9, 3:] *= 1e-8
    xi[9, :] = 0.0
    return xi


@pytest.mark.parametrize("shape", [(16, 6), (2, 8, 6), (16, 6, 1)])
def test_se3_exp_matches_jax(shape):
    xi = _twists(0).reshape(shape)
    _close(T.se3_exp(_t(xi)), G.se3_exp(jnp.asarray(xi)))


def test_se3_exp_small_angle_branch_is_finite_and_first_order():
    xi = _twists(1)
    ours = T.se3_exp(_t(xi)).numpy()
    assert np.isfinite(ours).all()
    # zero twist is the identity, exactly
    np.testing.assert_array_equal(ours[9], np.eye(4, dtype=np.float32))
    # the gradient through the unused branch stays finite
    x = _t(xi).requires_grad_(True)
    T.se3_exp(x).sum().backward()
    assert torch.isfinite(x.grad).all()


def test_hat_operators_match_jax():
    xi = _twists(2)
    _close(T.so3_hat(_t(xi[:, 3:])), G.so3_hat(jnp.asarray(xi[:, 3:])))
    _close(T.se3_hat(_t(xi)), G.se3_hat(jnp.asarray(xi)))


def test_rigid_transform_ops_match_jax():
    rng = np.random.RandomState(3)
    a, b = rigid_transforms(rng, 5), rigid_transforms(rng, 5)
    pts = rng.randn(5, 100, 3).astype(np.float32)
    _close(T.compose_transformations(_t(a), _t(b)), G.compose_transformations(a, b))
    _close(T.inverse_transformation(_t(a)), G.inverse_transformation(a))
    _close(T.transform_pointcloud(_t(pts), _t(a)), G.transform_pointcloud(pts, a), atol=1e-5)
    _close(T.transform_normals(_t(pts), _t(a)), G.transform_normals(pts, a), atol=1e-5)
    # one unbatched (4, 4) transform applied to a batch of clouds
    _close(T.transform_pointcloud(_t(pts), _t(a[0])),
           G.transform_pointcloud(pts, a[0]), atol=1e-5)
    _close(T.transform_normals(_t(pts), _t(a[0])), G.transform_normals(pts, a[0]), atol=1e-5)


def test_transform_ops_reject_bad_shapes():
    with pytest.raises(ValueError):
        T.inverse_transformation(torch.eye(3))
    with pytest.raises(ValueError):
        T.transform_pointcloud(torch.zeros(4, 2), torch.eye(4))


@pytest.mark.parametrize("normalized", [True, False])
def test_create_meshgrid_matches_jax(normalized):
    ours = T.create_meshgrid(5, 7, normalized_coords=normalized)
    _close(ours, G.create_meshgrid(5, 7, normalized_coords=normalized))
    assert ours.dtype == torch.float32


def test_projection_ops_match_jax():
    rng = np.random.RandomState(4)
    K = np.eye(4, dtype=np.float32)
    K[0, 0], K[1, 1], K[0, 2], K[1, 2] = 480.0, -480.0, 319.5, 239.5  # ICL's negative fy
    cam = rng.randn(2, 50, 3).astype(np.float32)
    cam[0, :5, 2] = 0.0  # the z == 0 guard
    Kb = np.stack([K, K * 0.5])
    _close(T.project_points(_t(cam), _t(K)), G.project_points(cam, K), atol=1e-3)
    _close(T.project_points(_t(cam), _t(Kb)), G.project_points(cam, Kb), atol=1e-3)
    _close(T.inverse_intrinsics(_t(Kb)), G.inverse_intrinsics(Kb))
    _close(T.homogenize_points(_t(cam)), G.homogenize_points(cam))
    pix = rng.rand(2, 50, 2).astype(np.float32) * 100
    depth = rng.rand(2, 50).astype(np.float32)
    kinv = np.asarray(G.inverse_intrinsics(Kb))[:, :3, :3]
    _close(T.unproject_points(_t(pix), _t(kinv), _t(depth)),
           G.unproject_points(pix, kinv, depth), atol=1e-5)


@pytest.mark.parametrize("eps", [1e-6, 0.5])
def test_project_points_accepts_eps_as_jax_does(eps):
    """JAX's ``project_points(cam_coords, proj_mat, eps=1e-6)`` takes
    ``eps`` (its guard tests z == 0 exactly); the port takes it by name and
    by position and agrees with JAX."""
    rng = np.random.RandomState(7)
    K = np.eye(4, dtype=np.float32)
    K[0, 0], K[1, 1], K[0, 2], K[1, 2] = 525.0, 525.0, 319.5, 239.5
    cam = rng.randn(2, 20, 3).astype(np.float32)
    cam[0, :3, 2] = 0.0
    want = G.project_points(cam, K, eps=eps)
    _close(T.project_points(_t(cam), _t(K), eps=eps), want, atol=1e-3)
    _close(T.project_points(_t(cam), _t(K), eps), want, atol=1e-3)


def test_geometry_keeps_input_dtype():
    xi = torch.from_numpy(_twists(5).astype(np.float64))
    T64 = T.se3_exp(xi)
    assert T64.dtype == torch.float64
    assert T.inverse_transformation(T64).dtype == torch.float64
    assert T.create_meshgrid(3, 4, dtype=torch.float64).dtype == torch.float64


# --------------------------------------------------------------------------- #
# RGBDImages derived maps
# --------------------------------------------------------------------------- #
MAP_TOL = {"vertex_map": 1e-4, "global_vertex_map": 1e-4,
           "normal_map": 1e-3, "global_normal_map": 1e-3}


@pytest.mark.parametrize("name", sorted(MAP_TOL))
def test_derived_maps_match_reference_goldens(name):
    m = msrd()
    _, tf = both_frames(m["colors"], m["depths"], m["intrinsics"], m["poses"])
    _close(getattr(tf, name), m[name], atol=MAP_TOL[name])


@pytest.mark.parametrize("pitch", [1, 3])
def test_derived_maps_match_jax(pitch):
    rgb, depth, K, P = synthetic_sequence(2, 2, 24, 32, seed=pitch)
    depth[0, 0, 3:6, 4:9] = 0.0  # a hole: invalid depth zeroes every map there
    jf, tf = both_frames(rgb, depth, K, P, normal_pitch=pitch)
    for name, tol in MAP_TOL.items():
        _close(getattr(tf, name), getattr(jf, name), atol=tol)
    np.testing.assert_array_equal(tf.valid_depth_mask.numpy(), np.asarray(jf.valid_depth_mask))
    np.testing.assert_array_equal(tf.pixel_pos.numpy(), np.asarray(jf.pixel_pos))


def test_degenerate_normals_are_zero_like_jax():
    # A flat, fronto-parallel patch seen along one row only: tangents that
    # are parallel give a zero normal on both sides, never NaN.
    rgb, depth, K, P = synthetic_sequence(1, 1, 8, 8, seed=0)
    depth[..., 4:, :, :] = 0.0
    depth[..., 3, :, :] = 1.0
    jf, tf = both_frames(rgb, depth, K, P)
    ours = tf.normal_map.numpy()
    assert np.isfinite(ours).all()
    _close(tf.normal_map, jf.normal_map, atol=1e-3)


def test_rgbdimages_indexing_and_poses():
    rgb, depth, K, P = synthetic_sequence(2, 3, 8, 10)
    _, tf = both_frames(rgb, depth, K, P)
    assert tf.shape == (2, 3, 8, 10)
    one = tf[:, 1]
    assert one.shape == (2, 1, 8, 10)
    np.testing.assert_array_equal(one.poses.numpy(), P[:, 1:2])
    assert tf[1].shape == (1, 3, 8, 10)
    moved = one.with_poses(_t(P[:, :1]))
    np.testing.assert_array_equal(moved.poses.numpy(), P[:, :1])
    np.testing.assert_array_equal(moved.depth_image.numpy(), depth[:, 1:2])
    with pytest.raises(ValueError):
        type(tf)(tf.rgb_image, tf.depth_image[..., :2, :], tf.intrinsics)
    with pytest.raises(ValueError):
        type(tf)(tf.rgb_image, tf.depth_image, tf.intrinsics, normal_pitch=0)


@pytest.mark.parametrize("noise", [0.0, 1e-4, 1e-2])
def test_orthonormalize_rotations_matches_jax(noise):
    """Within 1e-6 of JAX, and a Newton step shrinks an orthonormality error
    ``eps`` to ``O(eps^2)``; the translation is left as it was."""
    rng = np.random.RandomState(9)
    T0 = rigid_transforms(rng, 12).reshape(3, 4, 4, 4)
    T0[..., :3, :3] += (noise * rng.randn(3, 4, 3, 3)).astype(np.float32)
    ours = T.orthonormalize_rotations(torch.from_numpy(T0))
    theirs = np.asarray(G.orthonormalize_rotations(jnp.asarray(T0)))
    np.testing.assert_allclose(ours.numpy(), theirs, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(ours[..., :3, 3].numpy(), T0[..., :3, 3])
    def ortho_err(R):
        R = torch.as_tensor(R).double()
        return float((R.transpose(-1, -2) @ R - torch.eye(3, dtype=torch.float64)).abs().max())

    assert ortho_err(ours[..., :3, :3]) < max(1e-6, 2 * ortho_err(T0[..., :3, :3]) ** 2)
    with pytest.raises(ValueError):
        T.orthonormalize_rotations(torch.zeros(3, 3))
