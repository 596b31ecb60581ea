"""``Pointclouds`` buffers of the port held against the JAX package on the
CPU: compaction with overflow, capacity growth, the ICP window's
``num_dropped`` accounting and the numpy interop. Writes that JAX parks
past the end of an array are dropped by the scatter here; every test runs under
``torch.use_deterministic_algorithms(True)``, which holds only if each
destination is written once."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import gradslam_tpu as G  # noqa: E402
from gradslam_torch import Pointclouds, RGBDImages  # noqa: E402
from gradslam_torch.interop import (  # noqa: E402
    pointclouds_from_numpy,
    rgbdimages_from_numpy,
    to_numpy,
)
from gradslam_torch.odometry.icputils import downsample_pointclouds  # noqa: E402
from gradslam_torch.structures.pointclouds import compact_masked, scatter_rows  # noqa: E402
from gradslam_tpu.odometry.icputils import (  # noqa: E402
    downsample_pointclouds as jax_downsample_pointclouds,
)
from gradslam_tpu.structures.pointclouds import _compact_masked as jax_compact  # noqa: E402

from ._parity import jax_map_to_torch  # noqa: E402


@pytest.fixture(autouse=True)
def deterministic():
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(before)


def _cloud(seed, B=2, M=40, C=3):
    rng = np.random.RandomState(seed)
    return rng.randn(B, M, C).astype(np.float32), rng.rand(B, M) < 0.6


@pytest.mark.parametrize("capacity", [40, 25, 10, 1])
def test_compact_masked_matches_jax_including_overflow(capacity):
    values, mask = _cloud(0)
    ours, counts = compact_masked(torch.from_numpy(values), torch.from_numpy(mask), capacity)
    theirs, jcounts = jax_compact(jnp.asarray(values), jnp.asarray(mask), capacity)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    assert ours.shape == (2, capacity, 3)


def test_compact_masked_keeps_order_and_zero_pads():
    values = torch.arange(12, dtype=torch.float32).reshape(1, 6, 2)
    mask = torch.tensor([[False, True, False, True, True, False]])
    out, counts = compact_masked(values, mask, 4)
    assert counts.tolist() == [3]
    np.testing.assert_array_equal(out[0].numpy(), [[2, 3], [6, 7], [8, 9], [0, 0]])


def test_scatter_rows_drops_trash_rows():
    dest = torch.tensor([[2, 5, 0, 3]])  # 5 and 3 are past size 3: trash
    vals = torch.tensor([[10, 11, 12, 13]])
    out = scatter_rows(3, dest, vals, fill=-1)
    assert out.tolist() == [[12, -1, 10]]


def test_with_capacity_grows_and_keeps_contents():
    pc = pointclouds_from_numpy(
        np.ones((2, 5, 3)), [5, 2], normals=np.ones((2, 5, 3)),
        colors=np.ones((2, 5, 3)), features=np.ones((2, 5, 1)), num_dropped=[0, 3],
        device="cpu",
    )
    grown = pc.with_capacity(9)
    assert grown.capacity == 9
    for name in ("points", "normals", "colors", "features"):
        buf = getattr(grown, name).numpy()
        np.testing.assert_array_equal(buf[:, :5], getattr(pc, name).numpy())
        np.testing.assert_array_equal(buf[:, 5:], 0.0)
    assert grown.num_points.tolist() == [5, 2]
    assert grown.num_dropped.tolist() == [0, 3]
    assert pc.with_capacity(5) is pc
    with pytest.raises(ValueError):
        pc.with_capacity(4)


def test_quantized_layout_empty_and_grown_match_jax():
    """The quantized map layout: no colors, features ``[ccount,
    packed_color]``; growing it keeps colors None and pads the features."""
    pc = Pointclouds.empty(2, 5, device="cpu", has_colors=False, feature_dim=2)
    jpc = G.Pointclouds.empty(2, 5, has_colors=False, feature_dim=2)
    assert pc.colors is None and jpc.colors is None
    feats = np.arange(20, dtype=np.float32).reshape(2, 5, 2)
    pc = pointclouds_from_numpy(np.ones((2, 5, 3)), [5, 3], normals=np.ones((2, 5, 3)),
                                features=feats, num_dropped=[0, 0], device="cpu")
    jpc = G.Pointclouds(points=jnp.ones((2, 5, 3)), num_points=jnp.asarray([5, 3]),
                        normals=jnp.ones((2, 5, 3)), features=jnp.asarray(feats),
                        num_dropped=jnp.zeros(2, jnp.int32))
    grown, jgrown = pc.with_capacity(8), jpc.with_capacity(8)
    assert grown.colors is None and jgrown.colors is None
    np.testing.assert_array_equal(grown.features.numpy(), np.asarray(jgrown.features))
    assert grown.features_list[1].shape == (3, 2)


def test_with_capacity_matches_jax():
    values, _ = _cloud(1)
    jpc = G.Pointclouds(points=jnp.asarray(values), num_points=jnp.asarray([30, 12]))
    tpc = jax_map_to_torch(jpc)
    np.testing.assert_array_equal(
        tpc.with_capacity(64).points.numpy(), np.asarray(jpc.with_capacity(64).points)
    )


def test_empty_nonpad_mask_and_lists():
    pc = Pointclouds.empty(2, 4, device="cpu", dtype=torch.float64, feature_dim=2)
    assert pc.points.dtype == torch.float64 and pc.features.shape == (2, 4, 2)
    assert pc.num_points.dtype == torch.int64 and pc.num_dropped.tolist() == [0, 0]
    pc = pointclouds_from_numpy(np.arange(24).reshape(2, 4, 3), [1, 3], device="cpu")
    assert pc.nonpad_mask.tolist() == [[True, False, False, False], [True, True, True, False]]
    lists = pc.points_list
    assert [len(p) for p in lists] == [1, 3]
    np.testing.assert_array_equal(lists[1], np.arange(12, 21).reshape(3, 3))
    assert pc.normals_list is None
    with pytest.raises(ValueError):
        Pointclouds(points=torch.zeros(2, 4, 3), num_points=torch.zeros(2),
                    normals=torch.zeros(2, 5, 3))


@pytest.mark.parametrize("capacity", [64, 9])
def test_downsample_pointclouds_matches_jax_with_overflow(capacity):
    rng = np.random.RandomState(2)
    B, CAP = 2, 80
    pts = rng.randn(B, CAP, 3).astype(np.float32)
    nrm = rng.randn(B, CAP, 3).astype(np.float32)
    active = rng.rand(B, CAP) < 0.8
    pix_h = rng.randint(0, 12, (B, CAP))
    pix_w = rng.randint(0, 16, (B, CAP))
    jpc = G.Pointclouds(points=jnp.asarray(pts), num_points=jnp.asarray([CAP, 50]),
                        normals=jnp.asarray(nrm))
    theirs = jax_downsample_pointclouds(
        jpc, jnp.asarray(active), jnp.asarray(pix_h, jnp.int32),
        jnp.asarray(pix_w, jnp.int32), 2, capacity,
    )
    ours = downsample_pointclouds(
        jax_map_to_torch(jpc), torch.from_numpy(active), torch.from_numpy(pix_h),
        torch.from_numpy(pix_w), 2, capacity,
    )
    np.testing.assert_array_equal(ours.points.numpy(), np.asarray(theirs.points))
    np.testing.assert_array_equal(ours.normals.numpy(), np.asarray(theirs.normals))
    np.testing.assert_array_equal(ours.num_points.numpy(), np.asarray(theirs.num_points))
    np.testing.assert_array_equal(ours.num_dropped.numpy(), np.asarray(theirs.num_dropped))
    if capacity == 9:
        assert (ours.num_dropped > 0).all()


def test_interop_round_trip():
    rng = np.random.RandomState(3)
    pc = pointclouds_from_numpy(
        rng.randn(1, 6, 3), [4], normals=rng.randn(1, 6, 3),
        colors=rng.rand(1, 6, 3), features=rng.rand(1, 6, 1), num_dropped=[2], device="cpu",
    )
    assert pc.points.dtype == torch.float32 and pc.num_points.dtype == torch.int64
    back = pointclouds_from_numpy(**to_numpy(pc), device="cpu")
    for name in ("points", "num_points", "normals", "colors", "features", "num_dropped"):
        np.testing.assert_array_equal(getattr(back, name).numpy(), getattr(pc, name).numpy())

    rgb, depth = rng.rand(1, 2, 4, 5, 3), rng.rand(1, 2, 4, 5, 1)
    K, P = np.tile(np.eye(4), (1, 1, 1, 1)), np.tile(np.eye(4), (1, 2, 1, 1))
    frames = rgbdimages_from_numpy(rgb, depth, K, P, normal_pitch=2, device="cpu")
    assert isinstance(frames, RGBDImages) and frames.normal_pitch == 2
    again = rgbdimages_from_numpy(**to_numpy(frames), device="cpu")
    np.testing.assert_array_equal(again.depth_image.numpy(), depth.astype(np.float32))
    assert again.normal_pitch == 2


def test_interop_defaults_to_the_card():
    """A caller who forgets ``device=`` gets the card, not a silent run on
    the CPU: the default is ``"cuda"``, and on a machine without a card the
    call raises instead of building CPU tensors."""
    import inspect

    from gradslam_torch import interop

    for fn in (interop.pointclouds_from_numpy, interop.rgbdimages_from_numpy):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            pointclouds_from_numpy(np.zeros((1, 2, 3)), [1])
        with pytest.raises((AssertionError, RuntimeError)):
            rgbdimages_from_numpy(np.zeros((1, 1, 2, 2, 3)), np.ones((1, 1, 2, 2, 1)),
                                  np.tile(np.eye(4), (1, 1, 1, 1)))
