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
