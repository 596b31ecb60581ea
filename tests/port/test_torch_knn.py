"""The port's 1-NN search held against the JAX package on the CPU: the plain
PyTorch version (the CUDA kernel's contract) against
``gradslam_tpu.ops.nn_points`` and against the Pallas kernel in interpret
mode, on the same numpy inputs. Indices must match exactly; distances
within atol 1e-4 (float32 expanded form, summed in another order)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from gradslam_tpu.ops import nn_points as jax_nn_points  # noqa: E402
from gradslam_tpu.ops.knn_pallas import nn_points_pallas  # noqa: E402
from gradslam_torch.ops import nn_points, nn_points_auto  # noqa: E402


def _random():
    rng = np.random.RandomState(0)
    return rng.randn(600, 3), rng.randn(1100, 3), None


def _masked_nan_padding():
    rng = np.random.RandomState(1)
    tgt = rng.randn(300, 3)
    mask = rng.rand(300) < 0.5
    tgt[~mask] = np.nan  # garbage in padding rows must not poison a tile
    return rng.randn(100, 3), tgt, mask


def _batched():
    rng = np.random.RandomState(2)
    mask = rng.rand(2, 80) < 0.7
    return rng.randn(2, 50, 3), rng.randn(2, 80, 3), mask


def _ties():
    # every target appears three times, some sources sit exactly on one:
    # the smallest index must win
    rng = np.random.RandomState(3)
    base = rng.randn(200, 3)
    src = np.concatenate([rng.randn(40, 3), base[:40]])
    return src, np.concatenate([base, base, base]), None


CASES = {
    "random": _random,
    "masked_nan_padding": _masked_nan_padding,
    "batched": _batched,
    "ties": _ties,
}


def _inputs(name):
    src, tgt, mask = CASES[name]()
    return src.astype(np.float32), tgt.astype(np.float32), mask


def _torch_nn(src, tgt, mask, **kw):
    d, i = nn_points(
        torch.from_numpy(src), torch.from_numpy(tgt),
        None if mask is None else torch.from_numpy(mask), **kw,
    )
    return d.numpy(), i.numpy()


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_jax_nn_points(name):
    src, tgt, mask = _inputs(name)
    d_j, i_j = jax_nn_points(jnp.asarray(src), jnp.asarray(tgt),
                             None if mask is None else jnp.asarray(mask))
    d_t, i_t = _torch_nn(src, tgt, mask)
    assert i_t.dtype == np.int32 and d_t.dtype == np.float32
    np.testing.assert_array_equal(i_t, np.asarray(i_j))
    np.testing.assert_allclose(d_t, np.asarray(d_j), atol=1e-4)


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_pallas_kernel_interpret(name):
    from jax.experimental.pallas import tpu as pltpu

    src, tgt, mask = _inputs(name)
    with pltpu.force_tpu_interpret_mode():
        d_p, i_p = nn_points_pallas(jnp.asarray(src), jnp.asarray(tgt),
                                    None if mask is None else jnp.asarray(mask))
    d_t, i_t = _torch_nn(src, tgt, mask)
    np.testing.assert_array_equal(i_t, np.asarray(i_p))
    np.testing.assert_allclose(d_t, np.asarray(d_p), atol=1e-4)


def test_ties_go_to_first_copy_across_tiles():
    src, tgt, _ = _inputs("ties")
    # a tile of 64 puts the three copies of a target in different tiles
    _, idx = _torch_nn(src, tgt, None, tile_size=64)
    assert (idx < 200).all()
    np.testing.assert_array_equal(idx[40:], np.arange(40))


def test_tile_size_does_not_change_result():
    src, tgt, mask = _inputs("masked_nan_padding")
    d1, i1 = _torch_nn(src, tgt, mask, tile_size=1024)
    d2, i2 = _torch_nn(src, tgt, mask, tile_size=7)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(d1, d2, atol=1e-5)


def test_auto_dispatches_cpu_tensors_to_plain_version_and_detaches():
    src, tgt, mask = _inputs("batched")
    s = torch.from_numpy(src).requires_grad_(True)
    d, i = nn_points_auto(s, torch.from_numpy(tgt), torch.from_numpy(mask))
    d_ref, i_ref = _torch_nn(src, tgt, mask)
    assert not d.requires_grad
    np.testing.assert_array_equal(i.numpy(), i_ref)
    np.testing.assert_array_equal(d.numpy(), d_ref)


def test_bad_shapes_raise():
    with pytest.raises(ValueError):
        nn_points(torch.zeros(4, 2), torch.zeros(5, 3))
    with pytest.raises(ValueError):
        nn_points(torch.zeros(1, 4, 3), torch.zeros(5, 3))


def test_cuda_wrapper_rejects_cpu_tensors_before_building(monkeypatch):
    from gradslam_torch.ops import _build, knn_cuda

    def no_build():
        raise AssertionError("the wrapper must validate its inputs before it builds")

    monkeypatch.setattr(_build, "load_library", no_build)
    before = knn_cuda.launches
    src, tgt = torch.zeros(4, 3), torch.zeros(5, 3)
    with pytest.raises(ValueError, match="CUDA tensors"):
        knn_cuda.nn_points_cuda(src, tgt)
    with pytest.raises(ValueError, match="CUDA tensors"):
        knn_cuda.nn_points_cuda(src[None], tgt[None], torch.ones(1, 5, dtype=torch.bool))
    assert knn_cuda.launches == before


def test_missing_nvcc_raises_and_leaves_no_partial_build(monkeypatch, tmp_path):
    from gradslam_torch.ops import _build

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    build_dir = tmp_path / "build"
    monkeypatch.setattr(_build, "BUILD_DIR", build_dir)
    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    _build.load_library.cache_clear()
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.load_library()
    assert not build_dir.exists()
    assert _build.load_library.cache_info().currsize == 0


def test_build_digest_follows_sources_and_flags(tmp_path):
    from gradslam_torch.ops import _build

    src = tmp_path / "k.cu"
    src.write_text("// a")
    first = _build._digest([src])
    src.write_text("// b")
    assert _build._digest([src]) != first
    assert "-gencode" in _build.NVCC_FLAGS and "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert not any("fast_math" in f or "fast-math" in f for f in _build.NVCC_FLAGS)


# --- the CUDA kernel's split plan and merge rule, modelled in plain PyTorch ---
#
# The kernel cuts the targets into S contiguous splits (``split_plan``), keeps
# a running min per split and records the chunk (32 targets) where it last
# dropped strictly, merges the S partial minima in ascending split order with
# strict < from (1e30, none), recovers the first index in the winning chunk
# whose distance equals the minimum, and clamps. The model below does the
# same on the plain version's distances; it must reproduce the unsplit
# ``nn_points`` walk bit for bit.

from gradslam_torch.ops import knn_cuda  # noqa: E402
from gradslam_torch.ops.knn import _apply_tgt_mask, _sq_norm_fma  # noqa: E402

_C = knn_cuda.CHUNK
_H100 = dict(sms=132, resident=9)  # the card's SMs; search blocks an SM holds


def _split_ranges(M, S, per):
    return [(s * per, min((s + 1) * per, M)) for s in range(S)]


PLAN_SHAPES = [
    (1, 19_200, 38_400), (1, 4_800, 9_600), (1, 1_200, 2_400), (2, 777, 2_049),
    (1, 1, 5), (1, 100, 0), (1, 300, 31), (3, 300_000, 600_000),
]


@pytest.mark.parametrize("splits", [None, 1, 7, 64])
@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_split_plan_covers_every_target_once(shape, splits):
    B, N, M = shape
    S, per = knn_cuda.split_plan(B, N, M, _H100["sms"], _H100["resident"], splits)
    assert S >= 1 and per >= _C and per % _C == 0
    if splits is not None:
        assert S == splits
    covered = np.concatenate([np.arange(a, b) for a, b in _split_ranges(M, S, per) if b > a]
                             + [np.zeros(0, np.int64)])
    np.testing.assert_array_equal(covered, np.arange(M))  # each target once, in order
    if splits is None:
        assert all(a < b for a, b in _split_ranges(M, S, per)) or M == 0  # no empty split
        blocks = B * -(-N // knn_cuda.ROWS) * S
        assert S == 1 or -(-blocks // _H100["sms"]) <= _H100["resident"]  # one wave


def test_split_plan_fills_the_card_at_the_paths_shapes():
    # the parent kernel's grid was ceil(N / 256) blocks: 75, 19 and 5
    for N, M in [(19_200, 38_400), (4_800, 9_600), (1_200, 2_400)]:
        S, _ = knn_cuda.split_plan(1, N, M, _H100["sms"], _H100["resident"])
        assert -(-N // knn_cuda.ROWS) * S >= _H100["sms"] // 4, (N, M, S)


def _kernel_model(src, tgt, mask, S, per):
    """The kernel's split search and merge on the plain version's distances
    (tiles of one chunk, as ``nn_points(tile_size=CHUNK)`` computes them)."""
    B, N, M = src.shape[0], src.shape[1], tgt.shape[1]
    tgt0, pen = _apply_tgt_mask(tgt, mask)
    s2 = _sq_norm_fma(src)
    t2pen = _sq_norm_fma(tgt0) + pen
    tiles = [s2[:, :, None] + t2pen[:, None, a:a + _C]
             - 2.0 * torch.bmm(src, tgt0[:, a:a + _C].transpose(1, 2)) for a in range(0, M, _C)]
    m_pad = -(-M // _C) * _C
    d = torch.full((B, N, m_pad), float("inf"))  # padding rows never win
    if tiles:
        d[:, :, :M] = torch.cat(tiles, dim=2)
    d_nonan = torch.nan_to_num(d, nan=float("inf"))  # fminf skips a NaN
    inf, none = torch.full((B, N), 1e30), torch.full((B, N), -1, dtype=torch.int64)
    parts = []
    for a, b in _split_ranges(m_pad, S, per):
        best, chunk = inf, none
        for c in range(a, b, _C):
            prev = best
            best = torch.fmin(best, d_nonan[:, :, c:c + _C].amin(dim=2))
            chunk = torch.where(best < prev, c, chunk)
        parts.append((best, chunk))
    best, chunk = inf, none
    for part_d, part_c in parts:  # ascending split order, strict <
        take = part_d < best
        best, chunk = torch.where(take, part_d, best), torch.where(take, part_c, chunk)
    window = (chunk.clamp(min=0)[..., None] + torch.arange(_C)).clamp(max=max(m_pad - 1, 0))
    hits = torch.gather(d, 2, window) == best[..., None] if m_pad else torch.zeros(B, N, _C)
    idx = torch.where(chunk >= 0, chunk + hits.int().argmax(dim=2), 0)
    return torch.clamp(best, min=0.0), idx.to(torch.int32)


def _split_ties():
    # the three copies of every target lie in different splits of 128 rows
    rng = np.random.RandomState(5)
    base = rng.randn(200, 3)
    return np.concatenate([rng.randn(30, 3), base[:70]]), np.concatenate([base] * 3), None


def _near_duplicates():
    # each source sits on a target that has three twins within 1e-7 in
    # later splits: the distances round near 0, and for some sources two of
    # them below it, so the merge must compare them unclamped
    rng = np.random.RandomState(6)
    base = rng.randn(150, 3)
    return base[:90], np.concatenate([base + 3e-8 * k * rng.randn(150, 3) for k in range(4)]), None


def _one_row_all_masked():
    rng = np.random.RandomState(7)
    tgt = rng.randn(2, 260, 3)
    mask = np.stack([rng.rand(260) < 0.4, np.zeros(260, bool)])
    tgt[~mask] = np.nan
    return rng.randn(2, 70, 3), tgt, mask


def _few_targets():
    rng = np.random.RandomState(8)
    return rng.randn(90, 3), rng.randn(40, 3), None  # 2 chunks, fewer than S


def _no_targets():
    return np.random.RandomState(9).randn(20, 3), np.zeros((0, 3)), None


SPLIT_CASES = dict(CASES, split_ties=_split_ties, near_duplicates=_near_duplicates,
                   one_row_all_masked=_one_row_all_masked, few_targets=_few_targets,
                   no_targets=_no_targets)


@pytest.mark.parametrize("splits", [None, 1, 3, 8])
@pytest.mark.parametrize("name", sorted(SPLIT_CASES))
def test_split_merge_model_reproduces_unsplit_nn_points(name, splits):
    src, tgt, mask = SPLIT_CASES[name]()
    src, tgt = src.astype(np.float32), tgt.astype(np.float32)
    s, t = torch.from_numpy(src), torch.from_numpy(tgt)
    m = None if mask is None else torch.from_numpy(mask)
    if s.ndim == 2:
        s, t, m = s[None], t[None], None if m is None else m[None]
    S, per = knn_cuda.split_plan(s.shape[0], s.shape[1], t.shape[1], _H100["sms"],
                                 _H100["resident"], splits)
    d_model, i_model = _kernel_model(s, t, m, S, per)
    d_walk, i_walk = nn_points(s, t, m, tile_size=_C)
    torch.testing.assert_close(d_model, d_walk, rtol=0, atol=0)
    torch.testing.assert_close(i_model, i_walk, rtol=0, atol=0)
    if name in ("split_ties", "ties"):
        assert (i_model < tgt.shape[-2] // 3).all()  # the first copy wins
    if t.shape[1] == 0 or name == "one_row_all_masked":
        rows = slice(None) if t.shape[1] == 0 else 1
        assert (d_model[rows] == 1e30).all() and (i_model[rows] == 0).all()
    if t.shape[1] > 0:
        d_j, i_j = jax_nn_points(jnp.asarray(s.numpy()), jnp.asarray(t.numpy()),
                                 None if m is None else jnp.asarray(m.numpy()))
        np.testing.assert_array_equal(i_model.numpy(), np.asarray(i_j))
        np.testing.assert_allclose(d_model.numpy(), np.asarray(d_j), atol=1e-4)


@pytest.mark.parametrize("splits", [None, 3])
def test_cuda_wrapper_with_splits_rejects_cpu_tensors_before_building(monkeypatch, splits):
    from gradslam_torch.ops import _build

    def no_build():
        raise AssertionError("the wrapper must validate its inputs before it builds")

    monkeypatch.setattr(_build, "load_library", no_build)
    before = knn_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        knn_cuda.nn_points_cuda(torch.zeros(1, 4, 3), torch.zeros(1, 5, 3), splits=splits)
    assert knn_cuda.launches == before
