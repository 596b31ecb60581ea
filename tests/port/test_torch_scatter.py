"""The port's unique-row scatter held against JAX and against the Pallas
kernel it replaces, on the CPU.

- ``scatter_rows`` and ``scatter_rows_into`` (the dispatchers; on CPU
  tensors the plain version, ``gradslam_torch/ops/scatter.py``) against
  JAX's ``.at[b, dest].set(mode="drop", unique_indices=True)``: batched, C
  columns, float32/int32/int64 values, int32/int64 destinations, dropped
  rows (past the end and negative), every row dropped.
- The Pallas kernel body of ``scripts/microbench_scatter.py`` run in
  interpret mode at a small shape, against the plain version.
- Gradients against ``jax.grad`` of the same scatter.
- The CUDA wrapper refuses CPU tensors before it builds anything.

Tolerance: exact everywhere (a scatter copies values; the gradients are
gathers of the same values). Every test runs under
``torch.use_deterministic_algorithms(True)``, which holds only if each row
is written once.
"""

import functools
import importlib.util
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from gradslam_torch.ops import scatter_cuda  # noqa: E402
from gradslam_torch.ops.scatter import (  # noqa: E402
    scatter_rows_into_plain,
    scatter_rows_plain,
)
from gradslam_torch.structures.pointclouds import scatter_rows, scatter_rows_into  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_TORCH = {"float32": torch.float32, "int32": torch.int32, "int64": torch.int64}


@pytest.fixture(autouse=True)
def deterministic():
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(before)


def _case(seed, B, M, size, C, dtype, drop_frac):
    """Unique destinations per batch row from a permutation of
    ``[0, size + M)``; a fraction of rows is sent to -1. Values are
    ``(B, M)`` when ``C`` is None, else ``(B, M, C)``."""
    rng = np.random.RandomState(seed)
    dest = np.stack([rng.permutation(size + M)[:M] for _ in range(B)]).astype(np.int64)
    dest[rng.rand(B, M) < drop_frac] = -1
    shape = (B, M) if C is None else (B, M, C)
    if dtype == "float32":
        values = rng.randn(*shape).astype(np.float32)
    else:
        values = rng.randint(-(2**30), 2**30, shape).astype(dtype)
    return dest, values


def _jax_set(table, dest, values):
    B, M = dest.shape
    bidx = np.broadcast_to(np.arange(B)[:, None], (B, M))
    # JAX's drop mode wraps negative indices like numpy; send them past the end
    d = np.where(dest < 0, table.shape[1] + M, dest)
    return np.asarray(jnp.asarray(table).at[bidx, d].set(
        jnp.asarray(values), mode="drop", unique_indices=True))


CASES = [
    # (B, M, size, C, dtype, drop_frac)
    (1, 50, 40, None, "float32", 0.0),
    (1, 64, 48, 3, "float32", 0.2),
    (2, 30, 25, 3, "float32", 0.3),
    (2, 40, 100, 1, "int64", 0.1),
    (3, 17, 9, 2, "int32", 0.5),
    (2, 20, 30, 4, "float32", 1.0),  # every row dropped
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"B{c[0]}M{c[1]}S{c[2]}C{c[3]}{c[4]}d{c[5]}")
@pytest.mark.parametrize("dest_dtype", [torch.int64, torch.int32])
def test_scatter_rows_matches_jax_drop_scatter(case, dest_dtype):
    B, M, size, C, dtype, drop = case
    dest, values = _case(0, B, M, size, C, dtype, drop)
    fill = -7 if dtype != "float32" else 2.5
    table = np.full((B, size) + values.shape[2:], fill, dtype=values.dtype)
    theirs = _jax_set(table, dest, values)
    ours = scatter_rows(size, torch.from_numpy(dest).to(dest_dtype), torch.from_numpy(values),
                        fill=fill)
    assert ours.dtype == _TORCH[dtype] and ours.is_contiguous()
    np.testing.assert_array_equal(ours.numpy(), theirs)


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"B{c[0]}M{c[1]}S{c[2]}C{c[3]}{c[4]}d{c[5]}")
def test_scatter_rows_into_matches_jax_and_leaves_the_buffer(case):
    B, M, size, C, dtype, drop = case
    dest, values = _case(1, B, M, size, C, dtype, drop)
    _, buf = _case(2, B, size, size, C, dtype, 0.0)
    theirs = _jax_set(buf, dest, values)
    tbuf = torch.from_numpy(buf.copy())
    ours = scatter_rows_into(tbuf, torch.from_numpy(dest), torch.from_numpy(values))
    np.testing.assert_array_equal(ours.numpy(), theirs)
    np.testing.assert_array_equal(tbuf.numpy(), buf)  # functional: no write into buf


def test_scatter_rows_into_casts_values_to_the_buffer_dtype():
    buf = torch.zeros(1, 4, 3)
    out = scatter_rows_into(buf, torch.tensor([[2, 0]]), torch.ones(1, 2, 3, dtype=torch.float64))
    assert out.dtype == torch.float32
    assert out[0, :, 0].tolist() == [1.0, 0.0, 1.0, 0.0]


def _microbench():
    spec = importlib.util.spec_from_file_location(
        "microbench_scatter", os.path.join(REPO, "scripts", "microbench_scatter.py"))
    mb = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mb)
    return mb


@pytest.mark.parametrize("n, hw", [(64, 48), (40, 96)])
def test_plain_version_equals_the_pallas_kernel_in_interpret_mode(monkeypatch, n, hw):
    """The TPU kernel's own body (``_pallas_kernel``) at a small shape, run
    by Pallas's interpreter on the CPU: zero the table, then
    ``table[idx[i]] = val[i]`` with rows past the table dropped."""
    from jax.experimental import pallas as pl

    mb = _microbench()
    monkeypatch.setattr(mb, "N", n)
    monkeypatch.setattr(mb, "HW", hw)
    idx, val = mb.make_inputs(seed=3)
    pallas = pl.pallas_call(
        functools.partial(mb._pallas_kernel, 1),
        out_shape=jax.ShapeDtypeStruct((mb.HW,), jnp.float32),
        interpret=True,
    )(idx, val)
    xla = mb.xla_scatter(idx, val)
    ours = scatter_rows(hw, torch.from_numpy(np.array(idx))[None],
                        torch.from_numpy(np.array(val))[None])
    np.testing.assert_array_equal(np.asarray(pallas), np.asarray(xla))
    np.testing.assert_array_equal(ours[0].numpy(), np.asarray(pallas))
    if n > hw:
        assert (np.asarray(idx) >= hw).any()  # the drop path ran


def test_gradients_match_jax():
    """d/d(buf, values) of ``sum(w * scatter_rows_into(buf, dest, values))``
    and d/d(values) of ``sum(w * scatter_rows(size, dest, values))``,
    against ``jax.grad`` of the same functions."""
    B, M, size, C = 2, 30, 25, 3
    dest, values = _case(4, B, M, size, C, "float32", 0.3)
    _, buf = _case(5, B, size, size, C, "float32", 0.0)
    w = np.random.RandomState(6).randn(B, size, C).astype(np.float32)
    bidx = np.broadcast_to(np.arange(B)[:, None], (B, M))
    jd = np.where(dest < 0, size + M, dest)

    def j_into(b, v):
        return jnp.sum(jnp.asarray(w) * b.at[bidx, jd].set(v, mode="drop", unique_indices=True))

    def j_new(v):
        t = jnp.zeros((B, size, C), jnp.float32)
        return jnp.sum(jnp.asarray(w) * t.at[bidx, jd].set(v, mode="drop", unique_indices=True))

    jg_buf, jg_val = jax.grad(j_into, argnums=(0, 1))(jnp.asarray(buf), jnp.asarray(values))
    jg_new = jax.grad(j_new)(jnp.asarray(values))

    tb = torch.from_numpy(buf).requires_grad_()
    tv = torch.from_numpy(values).requires_grad_()
    td = torch.from_numpy(dest)
    (torch.from_numpy(w) * scatter_rows_into(tb, td, tv)).sum().backward()
    np.testing.assert_array_equal(tb.grad.numpy(), np.asarray(jg_buf))
    np.testing.assert_array_equal(tv.grad.numpy(), np.asarray(jg_val))
    tv2 = torch.from_numpy(values).requires_grad_()
    (torch.from_numpy(w) * scatter_rows(size, td, tv2)).sum().backward()
    np.testing.assert_array_equal(tv2.grad.numpy(), np.asarray(jg_new))
    # the dropped rows get no gradient
    assert (tv2.grad.numpy()[dest < 0] == 0).all()


def test_gradient_flows_through_the_autograd_function():
    """Float values that need a gradient go through the scatter's own
    backward (a gather at ``dest``), not through ``index_put``'s."""
    v = torch.randn(1, 3, 2, requires_grad=True)
    out = scatter_rows(4, torch.tensor([[3, -1, 0]]), v)
    assert type(out.grad_fn).__name__ == "_ScatterRowsBackward"
    out = scatter_rows_into(torch.zeros(1, 4, 2), torch.tensor([[3, -1, 0]]), v)
    assert type(out.grad_fn).__name__ == "_ScatterRowsIntoBackward"
    with torch.no_grad():
        assert scatter_rows(4, torch.tensor([[3, -1, 0]]), v).grad_fn is None


def test_plain_versions_are_what_the_dispatchers_run_on_the_cpu():
    dest, values = _case(7, 2, 20, 15, 3, "float32", 0.25)
    d, v = torch.from_numpy(dest), torch.from_numpy(values)
    before = scatter_cuda.launches
    np.testing.assert_array_equal(scatter_rows(15, d, v, fill=1.0).numpy(),
                                  scatter_rows_plain(15, d, v, fill=1.0).numpy())
    buf = torch.randn(2, 15, 3)
    np.testing.assert_array_equal(scatter_rows_into(buf, d, v).numpy(),
                                  scatter_rows_into_plain(buf, d, v).numpy())
    assert scatter_cuda.launches == before


def test_cuda_wrapper_rejects_cpu_tensors_before_building(monkeypatch):
    from gradslam_torch.ops import _build

    def no_build():
        raise AssertionError("the wrapper must validate its inputs before it builds")

    monkeypatch.setattr(_build, "load_library", no_build)
    before = scatter_cuda.launches
    dest, vals = torch.zeros(1, 3, dtype=torch.int64), torch.zeros(1, 3, 2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        scatter_cuda.scatter_rows_cuda(4, dest, vals)
    with pytest.raises(ValueError, match="CUDA tensors"):
        scatter_cuda.scatter_rows_into_cuda(torch.zeros(1, 4, 2), dest, vals)
    assert scatter_cuda.launches == before
