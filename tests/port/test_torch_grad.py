"""Gradients of the port's ground-truth pipelines against ``jax.grad`` on the
CPU, with respect to the depth images and the intrinsics, on one clip
(``synthetic_sequence(2, 3, 24, 32)`` with 5% of the depth pixels zeroed):
PointFusion with the ``sort_full`` association and the gather merge, with
the ``windowed`` association and the scatter merge, with a capacity
schedule and pruning, and ICPSLAM's aggregate map; the geometry under them
(``se3_exp`` on both sides of its small-angle branch, ``inverse_intrinsics``,
``orthonormalize_rotations``). Also ``remat`` (per-frame checkpointing), ``chamfer_distance``, the
``use_jit`` option, ``empty_map``'s device and the port's gradient example.

Bars: max |g_port - g_jax| <= 1e-4 * max |g_jax| for each gradient (the two
frameworks round the float32 map sums in another order; measured about
2e-6 of the largest gradient). ``remat=True`` must give the same forward
bits as ``remat=False`` and gradients within the same bar.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import gradslam_tpu as G  # noqa: E402
from gradslam_torch import ICPSLAM, PointFusion  # noqa: E402
from gradslam_torch.examples import gradient_refinement as example  # noqa: E402
from gradslam_torch.metrics import chamfer_distance  # noqa: E402
from gradslam_tpu.metrics import chamfer_distance as jax_chamfer_distance  # noqa: E402

from . import _gradparity as GP  # noqa: E402

BAR = 1e-4
CAP_WINDOWED = 4 * GP.L * GP.H * GP.W  # past 3 * H * W and 6 * H * W: windowed + scatter
CONFIGS = {
    "gt_sort_full_gather": ("PointFusion", dict(odom="gt", association="sort_full",
                                                merge="gather")),
    "gt_windowed_scatter": ("PointFusion", dict(odom="gt", association="windowed",
                                                merge="scatter", map_capacity=CAP_WINDOWED)),
    "icpslam_gt_aggregate": ("ICPSLAM", dict(odom="gt")),
    # capacity growth (with_capacity) and prune_map's compaction between
    # segments
    "gt_schedule_prune": ("PointFusion", dict(
        odom="gt", prune_every=2, prune_min_confidence=1.5,
        map_capacity=[(1, 2 * GP.H * GP.W), (2, 4 * GP.H * GP.W)])),
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
            cls, kw = CONFIGS[name]
            cache[name] = (GP.jax_grads(cls, kw, data, False),
                           GP.torch_run(cls, kw, data, False),
                           GP.torch_run(cls, kw, data, False, remat=True))
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
    """Invalid pixels (depth 0) get finite gradients, as in JAX: the normal
    map's double ``where`` and the masks keep NaN out of the backward."""
    (gd, _), (_, _, td, tk), _ = runs(name)
    zeroed = data[4]
    assert zeroed.sum() > 0
    assert bool(torch.isfinite(td).all()) and bool(torch.isfinite(tk).all())
    np.testing.assert_allclose(td.numpy()[zeroed], gd[zeroed], rtol=0,
                               atol=BAR * float(np.abs(gd).max()))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_remat_forward_bit_identical_and_gradients_agree(runs, name):
    (gd, gk), (pc0, p0, td0, tk0), (pc1, p1, td1, tk1) = runs(name)
    assert GP.same_forward((pc0, p0), (pc1, p1))
    assert GP.max_gap(td1, td0) <= BAR * float(np.abs(gd).max())
    assert GP.max_gap(tk1, tk0) <= BAR * float(np.abs(gk).max())


def test_remat_scatter_merge_backward_through_checkpoint(data):
    """The scatter merge's buffer gradient (``_ScatterRowsInto``'s backward,
    which runs the scatter again) under checkpoint recompute: the saved
    ``dest`` is recomputed, and the gradient to the old map rows is what
    the run without remat gives."""
    cls, kw = CONFIGS["gt_windowed_scatter"]
    seen = []
    from gradslam_torch.structures import pointclouds as PC

    real = PC._scatter_rows_into

    def spy(buf, dest, values):
        seen.append(torch.is_grad_enabled())
        return real(buf, dest, values)

    PC._scatter_rows_into = spy
    try:
        off = GP.torch_run(cls, kw, data, False)
        n_off = len(seen)
        on = GP.torch_run(cls, kw, data, False, remat=True)
    finally:
        PC._scatter_rows_into = real
    # remat off: L merges in the forward, L - 1 buffer gradients (frame 0's
    # map is the empty buffer, which needs none); remat on adds the L
    # recomputed merges
    assert n_off == GP.L + GP.L - 1
    assert len(seen) - n_off == n_off + GP.L
    assert torch.equal(on[2], off[2]) and torch.equal(on[3], off[3])


def _jax_pair(a, b, ma, mb):
    return (jnp.asarray(a), jnp.asarray(b), None if ma is None else jnp.asarray(ma),
            None if mb is None else jnp.asarray(mb))


@pytest.mark.parametrize("squared", [True, False])
@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("batched", [True, False])
def test_chamfer_distance_value_and_gradient_match_jax(squared, masked, batched):
    rng = np.random.RandomState(3)
    a = rng.randn(2, 50, 3).astype(np.float32)
    b = rng.randn(2, 70, 3).astype(np.float32)
    ma = rng.rand(2, 50) < 0.8 if masked else None
    mb = rng.rand(2, 70) < 0.7 if masked else None
    if not batched:
        a, b = a[0], b[0]
        ma, mb = (None, None) if not masked else (ma[0], mb[0])

    def jloss(x, y):
        return jnp.sum(jax_chamfer_distance(x, y, *_jax_pair(a, b, ma, mb)[2:], squared=squared))

    ja, jb = _jax_pair(a, b, ma, mb)[:2]
    want = float(jloss(ja, jb))
    wga, wgb = (np.asarray(g) for g in jax.grad(jloss, argnums=(0, 1))(ja, jb))
    ta = torch.tensor(a, requires_grad=True)
    tb = torch.tensor(b, requires_grad=True)
    out = chamfer_distance(ta, tb, None if ma is None else torch.tensor(ma),
                           None if mb is None else torch.tensor(mb), squared=squared)
    assert out.shape == ((2,) if batched else ())
    out.sum().backward()
    assert abs(float(out.sum().detach()) - want) <= 1e-5 * max(1.0, abs(want))
    assert GP.max_gap(ta.grad, wga) <= 1e-5 * float(np.abs(wga).max())
    assert GP.max_gap(tb.grad, wgb) <= 1e-5 * float(np.abs(wgb).max())


def test_chamfer_distance_of_a_cloud_with_itself_is_zero():
    pts = torch.tensor(np.random.RandomState(4).randn(1, 40, 3).astype(np.float32))
    assert float(chamfer_distance(pts, pts, squared=True)[0]) <= 1e-6


@pytest.mark.parametrize("cls", [PointFusion, ICPSLAM])
def test_use_jit_accepted_and_ignored(cls, data):
    """``use_jit`` is accepted as in the JAX constructors and changes
    nothing in eager PyTorch."""
    kw = dict(odom="gt")
    runs = [GP.torch_run(cls.__name__, dict(kw, use_jit=flag), data, False)
            for flag in (True, False)]
    assert GP.same_forward(runs[0][:2], runs[1][:2])
    assert torch.equal(runs[0][2], runs[1][2])
    assert cls(odom="gt", use_jit=False, remat=True).remat


@pytest.mark.parametrize("cls", [PointFusion, ICPSLAM])
def test_empty_map_defaults_to_the_card(cls):
    """As the interop functions: a caller who leaves out ``device=`` gets
    the card, and on a machine without one the call raises."""
    import inspect

    assert inspect.signature(cls.empty_map).parameters["device"].default == "cuda"
    cpu = cls(odom="gt").empty_map(1, 8, device="cpu")
    assert cpu.points.device.type == "cpu" and cpu.capacity == 8
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            cls(odom="gt").empty_map(1, 8)


def test_example_chamfer_recovers_calibration():
    """The settings and bars of the JAX example's own test
    (``tests/examples/test_gradient_refinement.py``)."""
    losses, rec_depth, rec_focal = example.refine(
        H=24, W=32, L=3, steps=25, lr=0.08, verbose=False, device="cpu")
    assert losses[-1] < 0.02 * losses[0]
    assert abs(rec_depth - 1.0) < 0.02
    assert abs(rec_focal - 1.0) < 0.03


def test_example_dense_depth_field_refinement():
    losses, before, after = example.refine(
        H=24, W=32, L=3, steps=30, lr=0.01, optimize="depth", verbose=False, device="cpu")
    assert losses[-1] < 0.05 * losses[0]
    assert after < 0.2 * before


def test_example_ate_with_gt_odometry_raises():
    with pytest.raises(ValueError, match="tracked odometry"):
        example.refine(H=24, W=32, L=2, steps=1, loss="ate", odometry="gt",
                       verbose=False, device="cpu")


def test_example_cli_runs_on_the_cpu(capsys):
    example.main(["--cpu", "--height", "16", "--width", "20", "--seqlen", "2",
                  "--steps", "2"])
    assert "recovered sensor model" in capsys.readouterr().out


def test_jax_chamfer_is_what_the_example_pairs_with():
    """The JAX example's chamfer is ``gradslam_tpu.metrics.chamfer_distance``;
    the port's example uses the port's, with the same signature."""
    import inspect

    assert (list(inspect.signature(chamfer_distance).parameters)
            == list(inspect.signature(G.metrics.chamfer_distance).parameters))


def _chip_smoke():
    import importlib.util
    import os

    root = os.path.join(os.path.dirname(__file__), "..", "..")
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(root, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def test_grad_golden_inputs_are_the_chip_smoke_rows():
    """``tests/port/data/grad_jax_cpu.npz`` (``make_grad_golden.py``) was
    made from the inputs that ``chip_smoke.py`` holds against it: each
    golden's shape, capacity and options are its row's, and its depth
    digest is that of the depth ``chip_smoke.grad_inputs`` builds."""
    import hashlib
    import json

    cs = _chip_smoke()
    golden = np.load(cs.GRAD_GOLDEN)
    assert sorted(cs.GRAD_GOLDEN_ROWS) == ["gt", "knn"]
    for key, row in cs.GRAD_GOLDEN_ROWS.items():
        shape, cap, kw, remats = cs.GRAD_ROWS[row]
        assert tuple(int(n) for n in golden[f"{key}_shape"]) == shape
        assert int(golden[f"{key}_capacity"]) == cap and True in remats
        assert json.loads(str(golden[f"{key}_config"])) == kw
        depth = cs.grad_inputs(shape, "cpu")[1].numpy()
        assert hashlib.sha256(depth.tobytes()).hexdigest() == str(golden[f"{key}_depth_sha256"])
        pix = golden[f"{key}_pix"]
        assert pix.shape == (4096,) and 0 <= pix.min() and pix.max() < depth.size


def test_chip_smoke_scatter_spy_sees_the_merge_and_catches_a_batch_offset(monkeypatch):
    """``chip_smoke.ScatterSpy`` keeps the scatter merge's forward call and
    its buffer gradient in the backward (not the recompute's calls), puts
    the dispatchers back, and its batch-distinct check fails a kernel that
    reads batch 0's ``dest`` for every batch row, which the real tensors of
    the synthetic clips (the same depths and poses in every batch row)
    would let pass."""
    from gradslam_torch.structures import pointclouds as PC

    cs = _chip_smoke()
    real = (PC._scatter_rows, PC._scatter_rows_into, PC._ScatterRowsInto.backward)
    monkeypatch.setattr(cs, "scatter_kernel", cs.scatter_plain)
    H, W = 12, 16
    slam = PointFusion(odom="gt", map_capacity=7 * H * W, remat=True)  # windowed + scatter
    with cs.ScatterSpy() as spy:
        cs.grad_step(slam, cs.grad_inputs((3, 3, H, W), "cpu"), spy)
    assert (PC._scatter_rows, PC._scatter_rows_into, PC._ScatterRowsInto.backward) == real
    assert sorted(spy.calls) == ["backward buffer gradient", "forward into buffer",
                                 f"forward table {H * W}", f"forward table {2 * H * W}"]
    buf, dest, values, _ = spy.calls["backward buffer gradient"]
    assert buf.shape == (3, 7 * H * W, 10) and dest.shape == (3, H * W)
    assert not values.any()  # the copy form: zeros over the overwritten rows
    calls = dict(spy.calls)
    assert spy.check("plain") == sorted(calls)
    spy.calls = calls
    monkeypatch.setattr(cs, "scatter_kernel", lambda t, d, v, f: cs.scatter_plain(
        t, d[:1].expand_as(d), v, f))
    with pytest.raises(AssertionError, match="batch-distinct"):
        spy.check("batch 0's dest")


def _twists(case):
    rng = np.random.RandomState(7)
    xi = rng.randn(4, 6).astype(np.float32)
    scale = {"zero": 0.0, "small_angle": 1e-7, "large_angle": 0.7}[case]
    xi[:, 3:] *= scale / np.linalg.norm(xi[:, 3:], axis=-1, keepdims=True)
    return xi


@pytest.mark.parametrize("fn, make", [
    ("se3_exp", lambda: _twists("zero")),
    ("se3_exp", lambda: _twists("small_angle")),
    ("se3_exp", lambda: _twists("large_angle")),
    ("inverse_intrinsics", lambda: GP.clip()[2]),
    ("orthonormalize_rotations", lambda: GP.clip()[3]),
], ids=["se3_exp_zero", "se3_exp_small_angle", "se3_exp_large_angle", "inverse_intrinsics",
        "orthonormalize_rotations"])
def test_geometry_gradient_matches_jax(fn, make):
    """Vector-Jacobian products of the geometry that the pipelines'
    gradients pass through, against the JAX package's (the small-angle
    branch of ``se3_exp`` and its double ``where`` included)."""
    import gradslam_torch.geometry as TG
    import gradslam_tpu.geometry as JG

    x = make().astype(np.float32)
    out_shape = np.asarray(getattr(JG, fn)(jnp.asarray(x))).shape
    w = np.random.RandomState(8).randn(*out_shape).astype(np.float32)
    (got,), (want,) = GP.vjp_torch(getattr(TG, fn), (x,), w), GP.vjp_jax(getattr(JG, fn), (x,), w)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
