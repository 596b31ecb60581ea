"""The geometry helpers of the port outside the pipelines' path (the grid
transforms, pixel normalisation, camera/pixel projection, quaternions, the
reference's ``*_3d`` names, ``unhomogenize_points`` and ``so3_exp``) held
against the JAX package on the CPU, on the same seeded numpy inputs.

Tolerances: 1e-6 for elementwise helpers (relative where a division by a
small homogeneous coordinate makes values large), 1e-5 for helpers built on
3x3 and 4x4 products."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import gradslam_tpu.geometry as J  # noqa: E402
import gradslam_torch.geometry as T  # noqa: E402
from gradslam_torch.geometry import geometryutils as Tg  # noqa: E402
from gradslam_torch.utils.precision import tf32_disabled  # noqa: E402
from gradslam_tpu.geometry import geometryutils as Jg  # noqa: E402

from ._parity import rigid_transforms  # noqa: E402

ELEMENTWISE = 1e-6
PRODUCTS = 1e-5


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _close(ours, theirs, atol, rtol=0.0):
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(theirs), atol=atol, rtol=rtol)


def _both(fn_name, *args, module_pair=(T, J), **kw):
    ours = getattr(module_pair[0], fn_name)(*[_t(a) if isinstance(a, np.ndarray) else a
                                              for a in args], **kw)
    theirs = getattr(module_pair[1], fn_name)(*[jnp.asarray(a) if isinstance(a, np.ndarray)
                                                else a for a in args], **kw)
    return ours, theirs


def _transforms(seed, shape):
    rng = np.random.RandomState(seed)
    n = int(np.prod(shape)) if shape else 1
    return rigid_transforms(rng, n).reshape(tuple(shape) + (4, 4))


def _projections(seed, shape):
    """Random ``(4, 4)`` projections ``K @ [R | t]``, not rigid: their
    rotation blocks carry focal lengths. R turns about the optical axis and
    t has no z part, so a projected point's z is its own z, and points at
    z == 0 meet the divide guard exactly."""
    rng = np.random.RandomState(seed)
    n = int(np.prod(shape)) if shape else 1
    K = np.eye(4, dtype=np.float32)
    K[0, 0], K[1, 1], K[0, 2], K[1, 2] = 120.0, 110.0, 31.5, 23.5
    out = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    a = rng.rand(n) * 2 * np.pi
    out[:, 0, 0], out[:, 0, 1], out[:, 1, 0], out[:, 1, 1] = (
        np.cos(a), -np.sin(a), np.sin(a), np.cos(a))
    out[:, :2, 3] = rng.randn(n, 2)
    return (K @ out).astype(np.float32).reshape(tuple(shape) + (4, 4))


def test_geometry_all_equals_the_jax_list():
    assert T.__all__ == J.__all__
    assert Tg.__all__ == Jg.__all__
    for name in T.__all__:
        assert callable(getattr(T, name))


def test_unhomogenize_points_with_points_at_infinity():
    rng = np.random.RandomState(0)
    pts = rng.randn(3, 50, 4).astype(np.float32)
    pts[0, :5, 3] = 0.0
    pts[1, :5, 3] = 1e-7  # |w| <= eps: scale 1
    pts[2, :5, 3] = 2e-5  # just above eps: large values
    ours, theirs = _both("unhomogenize_points", pts)
    assert ours.shape == (3, 50, 3)
    _close(ours, theirs, ELEMENTWISE, rtol=ELEMENTWISE)
    with pytest.raises(ValueError):
        T.unhomogenize_points(torch.ones(4))


def test_so3_exp_random_and_small_angles():
    rng = np.random.RandomState(1)
    omega = rng.randn(4, 8, 3).astype(np.float32)
    omega[0, :3] = 0.0
    omega[1, :3] *= 1e-8  # below the 1e-6 switch: first-order branch
    ours, theirs = _both("so3_exp", omega)
    assert ours.shape == (4, 8, 3, 3)
    _close(ours, theirs, PRODUCTS)
    # it is the rotation block of se3_exp
    xi = np.concatenate([np.zeros_like(omega), omega], axis=-1)
    _close(ours, T.se3_exp(_t(xi))[..., :3, :3], PRODUCTS)


@pytest.mark.parametrize("case", [
    ("unbatched over a grid", (), (6, 7, 3)),
    ("batched over a grid", (2,), (2, 6, 7, 3)),
    ("batched over rows", (3,), (3, 40, 3)),
    ("two batch dims", (2, 3), (2, 3, 5, 3)),
])
@pytest.mark.parametrize("fn", ["transform_pts_3d", "transform_pts_nd"])
def test_transform_pts_broadcasts_like_jax(case, fn):
    _, tshape, pshape = case
    T_ = _transforms(2, tshape)
    pts = np.random.RandomState(3).randn(*pshape).astype(np.float32)
    ours, theirs = _both(fn, pts, T_)
    assert tuple(ours.shape) == pshape
    _close(ours, theirs, PRODUCTS)


def test_transform_pts_nd_kf_alias_and_too_many_batch_dims():
    assert Tg.transform_pts_nd_KF is Tg.transform_pts_nd
    with pytest.raises(ValueError, match="exceed"):
        T.transform_pts_3d(torch.zeros(2, 3), torch.eye(4).expand(2, 3, 4, 4))
    with pytest.raises(ValueError):
        T.transform_pts_3d(torch.zeros(2, 3), torch.eye(3))


@pytest.mark.parametrize("shape", [(2, 6, 7, 2), (40, 2)])
def test_pixel_normalisation_round_trip(shape):
    rng = np.random.RandomState(4)
    H, W = 48, 64
    pix = (rng.rand(*shape) * [W - 1, H - 1]).astype(np.float32)
    ours, theirs = _both("normalize_pixel_coords", pix, H, W)
    _close(ours, theirs, ELEMENTWISE)
    back, jback = _both("unnormalize_pixel_coords", ours.numpy(), H, W)
    _close(back, jback, ELEMENTWISE)
    _close(back, pix, 1e-4)
    with pytest.raises(ValueError):
        T.normalize_pixel_coords(torch.zeros(3, 3), H, W)
    with pytest.raises(ValueError):
        T.unnormalize_pixel_coords(torch.zeros(3, 3), H, W)


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("fn", ["cam2pixel", "cam2pixel_KF"])
def test_cam2pixel_with_the_z_guard(fn, batched):
    rng = np.random.RandomState(5)
    P = _projections(6, (2,) if batched else ())
    cam = (rng.randn(2, 6, 7, 3) + [0.0, 0.0, 3.0]).astype(np.float32)
    cam[:, 0, :3, 2] = 0.0  # the divide-by-1 guard
    ours, theirs = _both(fn, cam, P, module_pair=(Tg, Jg))
    assert ours.shape == (2, 6, 7, 2)
    assert np.isfinite(ours.numpy()).all()
    _close(ours, theirs, PRODUCTS, rtol=PRODUCTS)
    with pytest.raises(ValueError):
        getattr(Tg, fn)(torch.zeros(4, 2), _t(P))


def test_pixel2cam_unprojects_a_grid():
    rng = np.random.RandomState(7)
    B, H, W = 2, 6, 7
    K = _projections(8, (B,))
    Kinv = np.linalg.inv(K).astype(np.float32)
    v, u = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    pix = np.stack([u, v, np.ones_like(u)], -1).astype(np.float32)
    pix = np.broadcast_to(pix, (B, H, W, 3)).copy()
    depth = (1.0 + rng.rand(B, H, W)).astype(np.float32)
    ours, theirs = _both("pixel2cam", depth, Kinv, pix)
    assert ours.shape == (B, H, W, 3)
    _close(ours, theirs, PRODUCTS)


def _quaternions(seed, n=64):
    rng = np.random.RandomState(seed)
    q = rng.randn(n, 4).astype(np.float32) * rng.rand(n, 1).astype(np.float32) * 3
    q[0] = 0.0  # the eps floor of the norm
    q[1] = [0.0, 0.0, 0.0, 1.0]  # identity: the small branch of axis-angle
    q[2] = [1e-14, 0.0, 0.0, -1.0]  # |xyz| below eps with w < 0
    q[3] = [0.3, -0.2, 0.5, 0.0]  # a half turn
    return q


def test_normalize_quaternion():
    q = _quaternions(9)
    ours, theirs = _both("normalize_quaternion", q)
    _close(ours, theirs, ELEMENTWISE)
    norms = np.linalg.norm(ours.numpy()[1:], axis=-1)
    np.testing.assert_allclose(norms, 1.0, atol=1e-6)
    with pytest.raises(ValueError):
        T.normalize_quaternion(torch.zeros(3))


def test_quaternion_to_rotation_matrix_order_is_xyzw():
    """Held on random quaternions, not on the identity: the JAX package reads
    ``(x, y, z, w)``, as scipy's scalar-last quaternions."""
    from scipy.spatial.transform import Rotation

    q = _quaternions(10)[4:]
    ours, theirs = _both("quaternion_to_rotation_matrix", q)
    _close(ours, theirs, ELEMENTWISE)
    np.testing.assert_allclose(ours.numpy(), Rotation.from_quat(q).as_matrix(), atol=1e-5)
    det = np.linalg.det(ours.numpy().astype(np.float64))
    np.testing.assert_allclose(det, 1.0, atol=1e-5)


def test_quaternion_to_axisangle():
    from scipy.spatial.transform import Rotation

    q = _quaternions(11)
    ours, theirs = _both("quaternion_to_axisangle", q)
    _close(ours, theirs, ELEMENTWISE, rtol=ELEMENTWISE)
    # back to the same rotation (the angle may exceed pi where w < 0)
    R = Rotation.from_rotvec(ours.numpy()[4:].astype(np.float64)).as_matrix()
    np.testing.assert_allclose(R, Rotation.from_quat(q[4:]).as_matrix(), atol=1e-5)


@pytest.mark.parametrize("shape", [(), (5,), (2, 3)])
def test_reference_3d_transform_names(shape):
    a, b = _transforms(12, shape), _transforms(13, shape)
    for fn, args in (("inverse_transfom_3d", (a,)), ("compose_transforms_3d", (a, b)),
                     ("relative_transform_3d", (a, b))):
        ours, theirs = _both(fn, *args, module_pair=(Tg, Jg))
        _close(ours, theirs, PRODUCTS)
    _close(Tg.inverse_transfom_3d(_t(a)), T.inverse_transformation(_t(a)), 0.0)
    _close(Tg.relative_transform_3d(_t(a), _t(b)),
           T.relative_transformation(_t(a), _t(b)), PRODUCTS)
    with pytest.raises(ValueError, match="same shape"):
        Tg.compose_transforms_3d(_t(a), torch.eye(4).expand((7,) + a.shape))


@pytest.mark.parametrize("call", [
    lambda: T.transform_pts_3d(torch.ones(2, 4, 3), torch.eye(4).expand(2, 4, 4)),
    lambda: Tg.compose_transforms_3d(torch.eye(4)[None], torch.eye(4)[None]),
    lambda: Tg.inverse_transfom_3d(torch.eye(4)[None]),
    lambda: T.so3_exp(torch.ones(2, 3)),
])
def test_products_run_with_tf32_off_and_restore_the_flags(monkeypatch, call):
    """A user calling a helper outside a pipeline, with TF32 allowed, gets
    float32 products, and finds the flags as they were afterwards."""
    seen = []
    real = torch.matmul

    def spy(*args, **kw):
        seen.append(tf32_disabled())
        return real(*args, **kw)

    monkeypatch.setattr(torch, "matmul", spy)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    call()
    assert seen and all(seen)
    assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
