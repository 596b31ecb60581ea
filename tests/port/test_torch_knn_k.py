"""``knn_points`` (K >= 1), ``estimate_normals`` and ``metrics.rpe`` of the
port, held against the JAX package on the CPU on seeded numpy inputs:
indices equal, distances within 1e-5 (float32 expanded form), gathered
neighbours exact; normals within 1e-5; RPE within 1e-5. Ties go to the
smallest target index, as JAX's stable top-K gives them, also across
target tiles; slots with no valid neighbour and rows past ``lengths1`` are
zero."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import gradslam_tpu as G  # noqa: E402
from gradslam_torch import Pointclouds, estimate_normals, pointclouds_from_rgbdimages  # noqa: E402
from gradslam_torch.interop import rgbdimages_from_numpy  # noqa: E402
from gradslam_torch.metrics import rpe  # noqa: E402
from gradslam_torch.ops import knn as knn_module  # noqa: E402
from gradslam_torch.ops import knn_points  # noqa: E402
from gradslam_tpu.datasets import synthetic_sequence  # noqa: E402
from gradslam_tpu.metrics import rpe as jax_rpe  # noqa: E402
from gradslam_tpu.ops.knn import knn_points as jax_knn_points  # noqa: E402
from gradslam_tpu.structures.utils import estimate_normals as jax_estimate_normals  # noqa: E402

from ._parity import rigid_transforms  # noqa: E402

KS = [1, 2, 8, 17]


def _clouds(B=2, N=300, M=260, seed=0, ties=False):
    rng = np.random.RandomState(seed)
    src = rng.randn(B, N, 3).astype(np.float32)
    tgt = rng.randn(B, M, 3).astype(np.float32)
    if ties:
        # exact copies of targets, in different tiles of 64 and inside one;
        # and sources at those targets, so the copies tie exactly
        tgt[:, 200] = tgt[:, 3]
        tgt[:, 130] = tgt[:, 3]
        tgt[:, 41] = tgt[:, 40]
        tgt[:, 250:255] = tgt[:, 10:11]
        src[:, :4] = tgt[:, [3, 40, 10, 3]]
        src[:, 4] = 0.5 * (tgt[:, 3] + tgt[:, 10])
    return src, tgt


def _compare(ours, theirs, K, nn=False):
    d, i, knn = ours
    jd, ji, jknn = theirs
    assert tuple(d.shape) == np.asarray(jd).shape and d.shape[-1] == K
    assert i.dtype == torch.int32
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=1e-5, rtol=1e-6)
    if nn:
        np.testing.assert_array_equal(knn.numpy(), np.asarray(jknn))
    else:
        assert knn is None and jknn is None


@pytest.mark.parametrize("K", KS)
def test_knn_points_matches_jax(K):
    src, tgt = _clouds(seed=K)
    ours = knn_points(torch.from_numpy(src), torch.from_numpy(tgt), K=K, tile_size=64)
    theirs = jax_knn_points(jnp.asarray(src), jnp.asarray(tgt), K=K, tile_size=64)
    _compare(ours, theirs, K)
    assert bool((ours.dists[..., 1:] >= ours.dists[..., :-1]).all())  # ascending


@pytest.mark.parametrize("K", KS)
def test_knn_points_ties_go_to_the_smallest_index_as_jax(K):
    src, tgt = _clouds(ties=True)
    ours = knn_points(torch.from_numpy(src), torch.from_numpy(tgt), K=K, return_nn=True,
                      tile_size=64)
    theirs = jax_knn_points(jnp.asarray(src), jnp.asarray(tgt), K=K, return_nn=True,
                            tile_size=64)
    _compare(ours, theirs, K, nn=True)
    if K >= 3:  # the three copies of target 3, in index order
        assert ours.idx[0, 0, :3].tolist() == [3, 130, 200]
        assert ours.idx[0, 2, :6].tolist() == [10, 250, 251, 252, 253, 254]


@pytest.mark.parametrize("K", KS)
def test_knn_points_lengths_and_return_nn_match_jax(K):
    src, tgt = _clouds(seed=10 + K)
    lengths1, lengths2 = np.array([250, 300]), np.array([200, 37])
    args = dict(K=K, return_nn=True, tile_size=64)
    ours = knn_points(torch.from_numpy(src), torch.from_numpy(tgt), torch.from_numpy(lengths1),
                      torch.from_numpy(lengths2), **args)
    theirs = jax_knn_points(jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(lengths1),
                            jnp.asarray(lengths2), **args)
    _compare(ours, theirs, K, nn=True)
    assert bool((ours.dists[0, 250:] == 0).all()) and bool((ours.idx[0, 250:] == 0).all())
    assert int(ours.idx[1].max()) < 37


@pytest.mark.parametrize("K", KS)
def test_knn_points_fewer_valid_targets_than_k_pads_with_zero_as_jax(K):
    """Masked rows hold NaN garbage: they are zeroed before the search, and
    the slots with no valid neighbour come back as distance 0, index 0;
    ``.knn`` gathers from the zeroed targets."""
    src, tgt = _clouds(seed=20 + K)
    mask = np.zeros(tgt.shape[:2], bool)
    mask[0, [5, 70, 130]] = True  # 3 valid targets
    mask[1, :] = True
    tgt[~mask] = np.nan
    args = dict(K=K, return_nn=True, tile_size=64)
    ours = knn_points(torch.from_numpy(src), torch.from_numpy(tgt),
                      tgt_mask=torch.from_numpy(mask), **args)
    theirs = jax_knn_points(jnp.asarray(src), jnp.asarray(tgt), tgt_mask=jnp.asarray(mask), **args)
    _compare(ours, theirs, K, nn=True)
    assert bool(torch.isfinite(ours.dists).all()) and bool(torch.isfinite(ours.knn).all())
    if K > 3:
        assert bool((ours.dists[0, :, 3:] == 0).all()) and bool((ours.idx[0, :, 3:] == 0).all())


@pytest.mark.parametrize("K", KS)
def test_knn_points_unbatched_and_iterable_as_jax(K):
    src, tgt = _clouds(B=1, seed=30 + K)
    ours = knn_points(torch.from_numpy(src[0]), torch.from_numpy(tgt[0]), None, 250, K, True)
    theirs = jax_knn_points(jnp.asarray(src[0]), jnp.asarray(tgt[0]), None, 250, K, True)
    assert tuple(ours.idx.shape) == (300, K) and tuple(ours.knn.shape) == (300, K, 3)
    _compare(ours, theirs, K, nn=True)
    d, i, nn = ours
    assert d is ours[0] and i is ours[1] and nn is ours[2]


def test_knn_points_refusals_match_jax():
    src, tgt = _clouds(N=5, M=4)
    for kw in ({"K": 0}, {"K": 5}):
        with pytest.raises(ValueError, match="K"):
            knn_points(torch.from_numpy(src), torch.from_numpy(tgt), **kw)
        with pytest.raises(ValueError, match="K"):
            jax_knn_points(jnp.asarray(src), jnp.asarray(tgt), **kw)


def test_knn_k1_goes_through_the_dispatcher(monkeypatch):
    """``K = 1`` is ``nn_points_auto`` (on the card, the 1-NN kernel)."""
    import gradslam_torch.ops as ops

    calls = []
    real = ops.nn_points_auto

    def spy(*args):
        calls.append(args)
        return real(*args)

    monkeypatch.setattr(ops, "nn_points_auto", spy)
    src, tgt = _clouds()
    out = knn_points(torch.from_numpy(src), torch.from_numpy(tgt), K=1)
    assert len(calls) == 1
    d, i = real(torch.from_numpy(src), torch.from_numpy(tgt))
    assert torch.equal(out.dists[..., 0], d) and torch.equal(out.idx[..., 0], i)
    knn_points(torch.from_numpy(src), torch.from_numpy(tgt), K=2)
    assert len(calls) == 1


def test_order_keys_round_trip_and_order():
    """The top-K keys order ``(d2, index)`` pairs as floats then indices,
    negative distances and -0.0 included, and give the pairs back bit for
    bit."""
    d = torch.tensor([-2.5, -1e-30, -0.0, 0.0, 1e-30, 3.0, 3.0, 1e30, -1e-7])
    i = torch.tensor([4, 8, 1, 0, 2, 9, 3, 5, 7])
    keys = knn_module._order_keys(d, i)
    order = torch.argsort(keys).tolist()
    expect = sorted(range(len(d)), key=lambda k: (float(d[k]), int(i[k])))
    assert order == expect
    dd, ii = knn_module._split_keys(keys)
    assert torch.equal(dd, d + 0.0) and torch.equal(ii, i.to(torch.int32))


def test_candidate_block_at_full_width_stays_at_a_few_gb():
    """At N = M = 307,200 with K = 17 (``estimate_normals(k=16)``) the
    default tile and the source chunks keep a tile's candidate keys and
    distances under 1 GB."""
    import inspect

    K = 17
    tile = inspect.signature(knn_points).parameters["tile_size"].default
    rows = min(307_200, knn_module._ROW_CHUNK)
    assert rows * (K + tile) * 8 + rows * tile * 4 < 1e9


@pytest.mark.parametrize("K", [2, 17])
def test_knn_points_in_source_chunks_gives_the_same_neighbours(monkeypatch, K):
    """Source chunks give the same neighbours; the distances may round an
    ulp apart, as the cross term's ``bmm`` may take another kernel for
    another row count."""
    src, tgt = _clouds(seed=40 + K, ties=True)
    whole = knn_points(torch.from_numpy(src), torch.from_numpy(tgt), K=K, tile_size=64)
    monkeypatch.setattr(knn_module, "_ROW_CHUNK", 37)
    chunked = knn_points(torch.from_numpy(src), torch.from_numpy(tgt), K=K, tile_size=64)
    assert torch.equal(chunked.idx, whole.idx)
    np.testing.assert_allclose(chunked.dists.numpy(), whole.dists.numpy(), atol=1e-6, rtol=0)


def _frame_cloud(B=1, H=24, W=32, seed=0):
    rgb, depth, K, P = synthetic_sequence(B, 1, H, W, seed=seed)
    jf = G.RGBDImages(jnp.asarray(rgb), jnp.asarray(depth), jnp.asarray(K), jnp.asarray(P))
    tf = rgbdimages_from_numpy(rgb, depth, K, P, device="cpu")
    return jf, tf


@pytest.mark.parametrize("k", [4, 8, 16])
def test_estimate_normals_matches_jax(k):
    """From k = 4 up: with k = 2 a pixel's three nearest points often lie on
    one image row, so the plane, and the normal, is not defined."""
    jf, tf = _frame_cloud(B=2)
    jpc = G.pointclouds_from_rgbdimages(jf[:, 0], capacity=24 * 32 + 40)
    pc = pointclouds_from_rgbdimages(tf[:, 0], capacity=24 * 32 + 40)
    views = np.array([[0.0, 0.0, 0.0], [0.1, -0.2, 0.05]], np.float32)
    theirs = jax_estimate_normals(jpc, k=k, viewpoints=jnp.asarray(views))
    ours = estimate_normals(pc, k=k, viewpoints=torch.from_numpy(views))
    np.testing.assert_allclose(ours.normals.numpy(), np.asarray(theirs.normals), atol=1e-5,
                               rtol=0)
    n = pc.num_points.tolist()
    assert bool((ours.normals[0, n[0]:] == 0).all())
    norms = torch.linalg.norm(ours.normals[0, :n[0]], dim=-1)
    np.testing.assert_allclose(norms.numpy(), 1.0, atol=1e-5)
    # facing the viewpoint
    assert bool((torch.sum(ours.normals[0, :n[0]] * -ours.points[0, :n[0]], -1) >= 0).all())


def test_estimate_normals_with_fewer_points_than_k_matches_jax():
    rng = np.random.RandomState(3)
    pts = rng.randn(2, 20, 3).astype(np.float32)
    num = np.array([5, 20])
    jpc = G.Pointclouds(points=jnp.asarray(pts), num_points=jnp.asarray(num))
    pc = Pointclouds(points=torch.from_numpy(pts), num_points=torch.from_numpy(num))
    theirs = jax_estimate_normals(jpc, k=8)
    ours = estimate_normals(pc, k=8)
    np.testing.assert_allclose(ours.normals.numpy(), np.asarray(theirs.normals), atol=1e-5,
                               rtol=0)
    with pytest.raises(ValueError, match="k must be"):
        estimate_normals(pc, k=1)
    with pytest.raises(ValueError, match="capacity"):
        estimate_normals(pc, k=20)
    with pytest.raises(ValueError, match="viewpoints"):
        estimate_normals(pc, k=4, viewpoints=torch.zeros(3))


def test_estimate_normals_agree_with_the_frame_normals():
    """On the smooth synthetic wall the plane fits agree with the frame's
    finite-difference normals (up to sign) away from the borders."""
    _, tf = _frame_cloud(H=48, W=64)
    pc = pointclouds_from_rgbdimages(tf[:, 0], filter_missing_depths=False)
    ours = estimate_normals(pc, k=16).normals[0].reshape(48, 64, 3)
    frame = tf.global_normal_map[0, 0]
    cos = torch.abs(torch.sum(ours * frame, -1))[4:-4, 4:-4]
    assert float((cos > np.cos(np.radians(5))).float().mean()) >= 0.99


@pytest.mark.parametrize("delta", [1, 3])
def test_rpe_matches_jax(delta):
    rng = np.random.RandomState(delta)
    gt = rigid_transforms(rng, 12)
    noise = rigid_transforms(rng, 12)
    noise[:, :3, 3] *= 0.01
    est = np.einsum("lij,ljk->lik", gt, noise).astype(np.float32)
    for reduce in (True, False):
        ours = rpe(torch.from_numpy(est), torch.from_numpy(gt), delta=delta, reduce=reduce)
        theirs = jax_rpe(jnp.asarray(est), jnp.asarray(gt), delta=delta, reduce=reduce)
        for o, t in zip(ours, theirs):
            np.testing.assert_allclose(o.numpy(), np.asarray(t), atol=1e-5, rtol=1e-5)
    zero_t, zero_r = rpe(torch.from_numpy(gt), torch.from_numpy(gt), delta=delta)
    assert float(zero_t) < 1e-5 and float(zero_r) < 1e-3


def test_rpe_refusals_match_jax():
    gt = torch.eye(4).expand(5, 4, 4)
    for args, match in (((gt, gt[:4]), "matching"), ((gt, gt, 0), "delta"),
                        ((gt, gt, 5), "smaller")):
        with pytest.raises(ValueError, match=match):
            rpe(*args)
        with pytest.raises(ValueError, match=match):
            jax_rpe(*(jnp.asarray(a.numpy()) if isinstance(a, torch.Tensor) else a
                      for a in args))


def test_estimate_normals_in_eigh_slices_gives_the_same_bits(monkeypatch):
    """The batched ``eigh`` runs in slices (cuSOLVER refuses a 307,200
    batch); slicing changes no bit."""
    from gradslam_torch.structures import utils as structures_utils

    _, tf = _frame_cloud(B=2)
    pc = pointclouds_from_rgbdimages(tf[:, 0])
    whole = estimate_normals(pc, k=8).normals
    monkeypatch.setattr(structures_utils, "_EIGH_BATCH", 97)
    assert torch.equal(estimate_normals(pc, k=8).normals, whole)
