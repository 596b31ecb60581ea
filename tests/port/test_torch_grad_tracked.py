"""Gradients of the port's tracked pipelines against ``jax.grad`` on the
CPU, with respect to the depth images and the intrinsics, through every
ICP solve, on one clip (``synthetic_sequence(2, 3, 24, 32)`` with 5% of the
depth pixels zeroed): gradICP with 1-NN association, gradICP with
projective association and symmetric normals, and the LM ``icp`` solver
with Tukey weights and constant velocity. The loss is ``sum(points^2)`` of
the map plus ``sum(t^2)`` of the poses' translations. Also ``remat`` on the
tracked body and the port's example with the trajectory loss.

Bars: max |g_port - g_jax| <= 1e-3 * max |g_jax| for each gradient: the
solvers' float32 normal equations, sums and 6x6 solves round in another
order than XLA's, and each frame's pose carries that into the next frame's
map (measured up to about 4e-6 of the largest gradient).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from gradslam_torch.examples import gradient_refinement as example  # noqa: E402

from . import _gradparity as GP  # noqa: E402

BAR = 1e-3
SOLVE = dict(dsratio=2, numiters=3)
CONFIGS = {
    "gradicp_knn": dict(odom="gradicp", **SOLVE),
    "gradicp_projective_sym": dict(odom="gradicp", odom_assoc="projective",
                                   odom_sym_normals=True, **SOLVE),
    "icp_tukey_constant_velocity": dict(odom="icp", robust_loss="tukey",
                                        motion_model="constant_velocity", **SOLVE),
}


@pytest.fixture(scope="module")
def data():
    return GP.clip()


@pytest.fixture(scope="module")
def runs(data):
    """For each configuration: JAX's gradients, then the port's run with
    ``remat`` off and on (computed once, on first use)."""
    cache = {}

    def get(name):
        if name not in cache:
            kw = CONFIGS[name]
            cache[name] = (GP.jax_grads("PointFusion", kw, data, True),
                           GP.torch_run("PointFusion", kw, data, True),
                           GP.torch_run("PointFusion", kw, data, True, remat=True))
        return cache[name]

    return get


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("wrt", ["depth", "intrinsics"])
def test_gradient_matches_jax(runs, name, wrt):
    (gd, gk), (_, _, td, tk), _ = runs(name)
    got, want = (td, gd) if wrt == "depth" else (tk, gk)
    scale = float(np.abs(want).max())
    assert scale > 0 and np.isfinite(want).all()
    assert GP.max_gap(got, want) <= BAR * scale


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_gradient_finite_at_zero_depth(runs, data, name):
    (gd, _), (_, _, td, tk), _ = runs(name)
    zeroed = data[4]
    assert bool(torch.isfinite(td).all()) and bool(torch.isfinite(tk).all())
    np.testing.assert_allclose(td.numpy()[zeroed], gd[zeroed], rtol=0,
                               atol=BAR * float(np.abs(gd).max()))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_remat_forward_bit_identical_and_gradients_agree(runs, name):
    """The tracked body (prediction, localization, map update, constant
    velocity) under checkpointing: the same poses and map bits, and the
    gradients of the run without it."""
    (gd, gk), (pc0, p0, td0, tk0), (pc1, p1, td1, tk1) = runs(name)
    assert GP.same_forward((pc0, p0), (pc1, p1))
    assert GP.max_gap(td1, td0) <= BAR * float(np.abs(gd).max())
    assert GP.max_gap(tk1, tk0) <= BAR * float(np.abs(gk).max())


def test_remat_recomputes_the_searches(data):
    """With remat, the backward runs each tracked frame's 1-NN searches
    again (two an iteration, 'fresh' lookahead) and the bootstrap frame's
    map update is not recomputed."""
    import gradslam_torch.odometry.icputils as IU

    real = IU.nn_points_auto
    calls = []

    def spy(*args):
        calls.append(torch.is_grad_enabled())
        return real(*args)

    IU.nn_points_auto = spy
    try:
        GP.torch_run("PointFusion", CONFIGS["gradicp_knn"], data, True, remat=True)
    finally:
        IU.nn_points_auto = real
    per_run = 2 * SOLVE["numiters"] * (GP.L - 1)
    assert len(calls) == 2 * per_run


def test_example_ate_recovers_calibration_through_gradicp():
    """The JAX example test's settings at 10 steps instead of 15, with its
    bars (``tests/examples/test_gradient_refinement.py``)."""
    losses, rec_depth, rec_focal = example.refine(
        H=24, W=32, L=3, steps=10, lr=0.03, loss="ate", odometry="gradicp",
        verbose=False, device="cpu")
    assert losses[-1] < 0.2 * losses[0]
    assert abs(rec_depth - 1.0) < 0.03
    assert abs(rec_focal - 1.0) < 0.04


def _guard_case(case, rng):
    """Inputs of the step guard: ``(xi (2, 6), A (2, N, 6), src (2, N, 3),
    mask (2, N))`` for a healthy step, a step the trust region cuts, a
    faded step, a zero step (``_safe_sqrt`` at 0) and exact ties of both
    bounds (inlier mass at the floor, displacement at the radius)."""
    N = 40
    src = rng.randn(2, N, 3).astype(np.float32)
    A = rng.randn(2, N, 6).astype(np.float32)
    mask = rng.rand(2, N) < 0.8
    xi = (1e-3 * rng.randn(2, 6)).astype(np.float32)
    if case == "trust":
        xi = (10 * rng.randn(2, 6)).astype(np.float32)
    elif case == "fade":
        A = (0.05 * A).astype(np.float32)
    elif case == "zero_step":
        xi = np.zeros((2, 6), np.float32)
    elif case == "ties":
        A = np.zeros((2, N, 6), np.float32)
        A[:, :3, 0] = 2.0  # squared-weight mass 12 = the floor exactly
        src = np.zeros((2, N, 3), np.float32)  # the centroid at 0, no spread
        mask = np.ones((2, N), bool)
        xi = np.zeros((2, 6), np.float32)
        xi[:, 0] = 0.5  # |v| = 10 * robust_scale: the radius exactly
    return xi, A, src, mask


@pytest.mark.parametrize("case", ["healthy", "trust", "fade", "zero_step", "ties"])
def test_step_guard_gradient_matches_jax(case):
    """``_guard_robust_step`` (trust region, inlier-mass fade,
    ``_safe_sqrt``) against the JAX package's, gradients to the twist, the
    rows and the cloud, including exact ties where JAX splits the
    gradient."""
    from gradslam_torch.odometry.icputils import _guard_robust_step
    from gradslam_tpu.odometry.icputils import _guard_robust_step as jax_guard

    rng = np.random.RandomState(["healthy", "trust", "fade", "zero_step", "ties"].index(case))
    xi, A, src, mask = _guard_case(case, rng)
    w = rng.randn(2, 6).astype(np.float32)
    got = GP.vjp_torch(lambda x, a, s: _guard_robust_step(x, a, 0.05, s, torch.tensor(mask)),
                     (xi, A, src), w)
    want = GP.vjp_jax(lambda x, a, s: jax.vmap(
        lambda x1, a1, s1, m1: jax_guard(x1, a1, 0.05, s1, m1))(x, a, s, jax.numpy.asarray(mask)),
        (xi, A, src), w)
    for g, h in zip(got, want):
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, h, rtol=1e-5, atol=1e-6)


def test_solve_linear_system_gradient_matches_jax():
    from gradslam_torch.odometry.icputils import solve_linear_system
    from gradslam_tpu.odometry.icputils import solve_linear_system as jax_solve

    rng = np.random.RandomState(5)
    A = rng.randn(2, 30, 6).astype(np.float32)
    b = rng.randn(2, 30, 1).astype(np.float32)
    w = rng.randn(2, 6, 1).astype(np.float32)
    got = GP.vjp_torch(lambda a, r: solve_linear_system(a, r, 1e-3), (A, b), w)
    want = GP.vjp_jax(lambda a, r: jax.vmap(lambda a1, r1: jax_solve(a1, r1, 1e-3))(a, r),
                    (A, b), w)
    for g, h in zip(got, want):
        np.testing.assert_allclose(g, h, rtol=1e-4, atol=1e-5)
