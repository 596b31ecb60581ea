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
- The CUDA wrapper refuses CPU tensors before it builds anything, and its
  pure parts: the fill's bits (:func:`scatter_cuda.fill_bits`) against
  torch's, the word widths (:func:`scatter_cuda.word_bytes`) for every row
  width the paths use, its input checks (B > 65,535 accepted, more than
  ``MAX_ROWS`` rows refused), and a numpy model of the kernel's partition
  (the grid-stride 16-byte fill or copy with its element tail, then one
  thread a flattened row in the planned words) against the plain version
  and JAX.

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


_MASK = {torch.float32: 0xFFFFFFFF, torch.int32: 0xFFFFFFFF, torch.int64: 0xFFFFFFFFFFFFFFFF}
_VIEW = {torch.float32: torch.int32, torch.int32: torch.int32, torch.int64: torch.int64}


@pytest.mark.parametrize("fill, dtype", [
    (0.0, torch.float32), (-0.0, torch.float32), (float("nan"), torch.float32),
    (float("inf"), torch.float32), (float("-inf"), torch.float32), (1.5, torch.float32),
    (float(532_480), torch.float32), (0, torch.float32),
    (-1, torch.int32), (2**31 - 1, torch.int32),
    (-1, torch.int64), (2**40 + 3, torch.int64), (307_200, torch.int64),
], ids=str)
def test_fill_bits_equal_torchs(fill, dtype):
    """The fill's bit pattern from numpy, as the wrapper passes it to the
    kernel, against the bits of a torch tensor holding the fill."""
    theirs = int(torch.tensor(fill, dtype=dtype).view(_VIEW[dtype]).item()) & _MASK[dtype]
    assert scatter_cuda.fill_bits(fill, dtype) == theirs


@pytest.mark.parametrize("C, dtype, offset, expect", [
    (1, torch.int64, 0, 8),     # fusion's winner table and row inversion
    (3, torch.float32, 0, 4),   # map points, normals, colors
    (6, torch.float32, 0, 8),   # the nested pyramid's coarser windows
    (8, torch.float32, 0, 16),  # the nested pyramid's packed finest window
    (10, torch.float32, 0, 8),  # prune rows, fusion rows with float colors
    (2, torch.int32, 0, 8),
    (1, torch.float32, 0, 4),
    (8, torch.float32, 4, 4),   # a 32-byte row read from a 4-byte-aligned address
    (8, torch.float32, 8, 8),
    (1, torch.int64, 8, 8),
])
def test_word_bytes_of_the_paths_rows(C, dtype, offset, expect):
    """The row word: the widest of 16, 8 and 4 bytes that divides the row's
    bytes and both addresses (the table from the allocator, 512-aligned;
    the values at ``offset`` bytes past an aligned address)."""
    row_bytes = C * scatter_cuda._ELEM[dtype]
    assert scatter_cuda.word_bytes(row_bytes, 1 << 20, (1 << 21) + offset) == expect
    assert scatter_cuda.word_bytes(1 << 20, 0) == 16  # a new table: 16-byte fill words


def _kernel_model(size, dest, values, fill, buf, stride, out_addr, src_addr, val_addr):
    """The kernel's partition in numpy, over the table's bytes: threads
    ``t < stride`` of the fill/copy grid write 16-byte words ``t, t +
    stride, ...`` below ``vec_words``, then element words from ``vec_words *
    16 / elem`` on (the copy form reads them from ``buf``); then thread ``r``
    of the row grid moves row ``r`` of the flattened ``B * M`` rows to table
    row ``(r // M) * size + dest[r]`` in the planned words, if ``0 <= dest[r]
    < size``. Every fill/copy byte must be written exactly once."""
    B, M = dest.shape
    elem = values.itemsize
    row_bytes = elem * int(np.prod(values.shape[2:], dtype=np.int64))
    nbytes = B * size * row_bytes
    out = np.zeros(nbytes, np.uint8)
    hits = np.zeros(nbytes, np.int64)
    if buf is None:
        word = np.array([scatter_cuda.fill_bits(fill, _TORCH[values.dtype.name])],
                        dtype=f"<u{elem}")
        src = np.tile(word.view(np.uint8), max(1, nbytes // elem))[:nbytes]
    else:
        src = np.ascontiguousarray(buf).view(np.uint8).reshape(-1)
    vec_words = nbytes // 16 if scatter_cuda.word_bytes(out_addr, src_addr) == 16 else 0
    for t in range(stride):
        for i in range(t, vec_words, stride):
            out[16 * i:16 * i + 16] = src[16 * i:16 * i + 16]
            hits[16 * i:16 * i + 16] += 1
        for i in range(vec_words * 16 // elem + t, nbytes // elem, stride):
            out[elem * i:elem * i + elem] = src[elem * i:elem * i + elem]
            hits[elem * i:elem * i + elem] += 1
    assert (hits == 1).all()
    if B * M and row_bytes and size:
        w = scatter_cuda.word_bytes(row_bytes, out_addr, val_addr)
        vals = np.ascontiguousarray(values).view(np.uint8).reshape(B * M, row_bytes)
        flat = dest.reshape(-1)
        for r in range(B * M):
            d = int(flat[r])
            if 0 <= d < size:
                o = ((r // M) * size + d) * row_bytes
                for k in range(row_bytes // w):  # one word at a time
                    out[o + k * w:o + k * w + w] = vals[r, k * w:k * w + w]
    return out.view(values.dtype).reshape((B, size) + values.shape[2:])


MODEL_CASES = [
    # (B, M, size, C, dtype, fill, dest dtype): tails of the 16-byte words
    (1, 1500, 1001, None, "float32", float("nan"), np.int64),  # 4-byte tail
    (1, 900, 1001, 2, "float32", -0.0, np.int64),  # 8-byte tail
    (1, 2000, 1001, 3, "float32", 1.5, np.int64),  # 12-byte tail
    (2, 700, 501, 1, "int64", -1, np.int64),  # 8-byte tail, int64
    (3, 0, 40, 3, "float32", 2.0, np.int64),  # B=3 with M=0: the fill alone
    (2, 50, 0, 3, "float32", 0.0, np.int64),  # size=0: no table
    (2, 300, 120, 3, "float32", float("inf"), np.int32),  # int32 dest
    (1, 400, 96, 8, "float32", 0.0, np.int64),  # 16-byte row words
    (1, 400, 96, 10, "float32", -7.0, np.int64),  # 8-byte row words
    (2, 64, 37, 2, "int32", 9, np.int32),
]


@pytest.mark.parametrize("case", MODEL_CASES,
                         ids=lambda c: f"B{c[0]}M{c[1]}S{c[2]}C{c[3]}{c[4]}{np.dtype(c[6]).name}")
@pytest.mark.parametrize("stride, val_offset", [(1, 0), (7, 0), (64, 4)])
@pytest.mark.parametrize("form", ["fill", "copy"])
def test_kernel_partition_model_equals_plain_and_jax(case, stride, val_offset, form):
    B, M, size, C, dtype, fill, dest_dtype = case
    dest, values = _case(10 + B + M + size, B, M, size, C, dtype, 0.2)
    if dest_dtype == np.int32:  # negative and past-the-end entries
        dest = dest.astype(np.int32)
        dest[:, ::7] = -5 - np.arange(dest[:, ::7].shape[1])
        assert (dest >= size).any() and (dest < 0).any()
    out_addr, val_addr = 1 << 20, (1 << 22) + val_offset
    if form == "fill":
        table = np.full((B, size) + values.shape[2:], fill, dtype=values.dtype)
        buf, src_addr = None, 0
        plain = scatter_rows_plain(size, torch.from_numpy(dest), torch.from_numpy(values), fill)
    else:
        _, buf = _case(5, B, size, size, C, dtype, 0.0)
        table, src_addr = buf, (1 << 23) + 4 * (stride == 7)  # one unaligned buffer: no vectors
        plain = scatter_rows_into_plain(torch.from_numpy(buf), torch.from_numpy(dest),
                                        torch.from_numpy(values))
    ours = _kernel_model(size, dest, values, fill, buf, stride, out_addr, src_addr, val_addr)
    # JAX holds int64 as int32 without x64; these values fit in 31 bits
    theirs = _jax_set(table, dest.astype(np.int64), values).astype(values.dtype)
    as_int = {"float32": np.int32}.get(dtype, values.dtype)
    np.testing.assert_array_equal(ours.view(as_int), plain.numpy().view(as_int))
    np.testing.assert_array_equal(ours.view(as_int), np.asarray(theirs).view(as_int))


def test_cuda_wrapper_takes_more_than_65535_batch_rows(monkeypatch):
    """Flattened rows: a batch past grid.y's 65,535 passes every input check
    down to the launch (recorded here instead of run), for both forms."""
    calls = []

    def record(out, src, bits, dest, values, size):
        calls.append((tuple(out.shape), src is not None, bits, tuple(dest.shape), size))
        return out

    monkeypatch.setattr(scatter_cuda, "_on_card", lambda *tensors: None)
    monkeypatch.setattr(scatter_cuda, "_launch", record)
    dest = torch.zeros(70_000, 2, dtype=torch.int32)
    values = torch.zeros(70_000, 2, 3)
    scatter_cuda.scatter_rows_cuda(4, dest, values, fill=-0.0)
    scatter_cuda.scatter_rows_into_cuda(torch.zeros(70_000, 5, 3), dest, values)
    assert calls == [((70_000, 4, 3), False, 0x80000000, (70_000, 2), 4),
                     ((70_000, 5, 3), True, 0, (70_000, 2), 5)]


@pytest.mark.parametrize("bad", ["rows", "float64", "float_dest", "shape", "strided",
                                 "buf_dtype", "buf_columns"])
def test_cuda_wrapper_input_checks_refuse(monkeypatch, bad):
    """What the kernel does not take raises in the wrapper's one validation
    pass, before anything is built: more than ``MAX_ROWS`` flattened rows
    (meta tensors, no memory), other dtypes, mismatched shapes, a strided
    tensor, a buffer of another dtype or row width."""
    from gradslam_torch.ops import _build

    def no_build():
        raise AssertionError("the wrapper must validate its inputs before it builds")

    monkeypatch.setattr(_build, "load_library", no_build)
    monkeypatch.setattr(scatter_cuda, "_on_card", lambda *tensors: None)
    dest, values, buf = torch.zeros(2, 5, dtype=torch.int64), torch.zeros(2, 5, 3), None
    if bad == "rows":
        dest = torch.empty(2, 2**30, dtype=torch.int32, device="meta")
        values = torch.empty(2, 2**30, device="meta")
    elif bad == "float64":
        values = values.double()
    elif bad == "float_dest":
        dest = dest.float()
    elif bad == "shape":
        values = torch.zeros(2, 4, 3)
    elif bad == "strided":
        values = torch.zeros(2, 5, 6)[..., ::2]
    elif bad == "buf_dtype":
        buf = torch.zeros(2, 7, 3, dtype=torch.float64)
    else:
        buf = torch.zeros(2, 7, 4)
    with pytest.raises(ValueError, match="the scatter kernel takes"):
        if buf is None:
            scatter_cuda.scatter_rows_cuda(7, dest, values)
        else:
            scatter_cuda.scatter_rows_into_cuda(buf, dest, values)
