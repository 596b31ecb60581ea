r"""Wrapper of the hand-written CUDA unique-row scatter (``csrc/scatter.cu``).

Same contract as :mod:`gradslam_torch.ops.scatter`, its plain version:
``scatter_rows_cuda`` builds a new ``(B, size, *C)`` table filled with
``fill``, ``scatter_rows_into_cuda`` a copy of an existing buffer; both then
write ``values (B, M, *C)`` to the rows ``dest (B, M)`` names and drop every
destination outside ``[0, size)``. Destinations inside the table must be
unique in each batch row.

The wrapper makes one validation pass (CUDA tensors on one device,
contiguous, float32/int32/int64 values, int32/int64 destinations, ``B * M``
rows under ``MAX_ROWS``; the message is built only on failure), allocates
the output with ``torch.empty``, picks the word widths (:func:`word_bytes`),
takes the fill's bits from numpy (:func:`fill_bits`) and makes one call into
the C entry point, bound once, on PyTorch's current stream of the tensors'
device; it raises if a launch is refused. A CPU tensor raises here: the
dispatchers :func:`gradslam_torch.structures.pointclouds.scatter_rows` and
``scatter_rows_into`` send those to the plain version, and carry the
gradient.

``launches`` counts wrapper calls that launch the row scatter
(``scatter_rows`` in ``scatter.cu``): one a call that has rows, columns and
a table to scatter into (the call's fill or copy of the table goes with it),
and nowhere else.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = [
    "scatter_rows_cuda", "scatter_rows_into_cuda", "fill_bits", "word_bytes", "MAX_ROWS",
    "launches",
]

launches = 0

MAX_ROWS = 2**31 - 1  # the kernel indexes the flattened B * M rows in int32
_ELEM = {torch.float32: 4, torch.int32: 4, torch.int64: 8}
_NUMPY = {torch.float32: np.float32, torch.int32: np.int32, torch.int64: np.int64}
_BITS = {4: np.uint32, 8: np.uint64}
_INDEX = (torch.int32, torch.int64)
_entry = None  # the C entry point, bound at the first launch


def fill_bits(fill, dtype: torch.dtype) -> int:
    r"""The bit pattern of ``fill`` as one element of ``dtype`` (float32,
    int32 or int64), as an unsigned integer: what ``torch.tensor(fill,
    dtype=dtype).view(int)`` holds, without a tensor."""
    return int(np.asarray(fill, dtype=_NUMPY[dtype]).view(_BITS[_ELEM[dtype]]))


def word_bytes(*sizes: int) -> int:
    r"""The widest word, 16, 8 or 4 bytes, that divides every one of
    ``sizes`` (a row's byte width and the addresses it is read from and
    written to). Every size the scatter passes is a multiple of 4."""
    g = 0
    for s in sizes:
        g |= s
    return 16 if g % 16 == 0 else 8 if g % 8 == 0 else 4


def _on_card(*tensors) -> None:
    dev = tensors[0].device
    if not all(t.device == dev for t in tensors) or dev.type != "cuda":
        where = ", ".join(str(t.device) for t in tensors)
        raise ValueError(f"the scatter kernel takes CUDA tensors on one device. Got {where}.")


def _check(dest: torch.Tensor, values: torch.Tensor, buf=None) -> None:
    shape = values.shape
    if (dest.dtype in _INDEX and values.dtype in _ELEM and dest.ndim == 2 and values.ndim >= 2
            and shape[:2] == dest.shape and dest.is_contiguous() and values.is_contiguous()
            and dest.numel() <= MAX_ROWS
            and (buf is None or (buf.dtype == values.dtype and buf.is_contiguous()
                                 and buf.ndim == values.ndim and buf.shape[0] == shape[0]
                                 and buf.shape[2:] == shape[2:]))):
        return
    raise ValueError(
        "the scatter kernel takes contiguous dest (B, M) int32/int64 and values (B, M, *C) "
        f"float32/int32/int64 with B * M <= {MAX_ROWS}"
        + ("" if buf is None else ", and buf (B, S, *C) of the values' dtype")
        + f". Got dest {dest.dtype} {tuple(dest.shape)}, values {values.dtype} {tuple(shape)}"
        + ("" if buf is None else f", buf {buf.dtype} {tuple(buf.shape)}") + "."
    )


def _launch(out: torch.Tensor, src, bits: int, dest: torch.Tensor, values: torch.Tensor,
            size: int) -> torch.Tensor:
    global launches, _entry
    if _entry is None:
        from ._build import load_library

        _entry = load_library().gradslam_scatter_rows
    elem = _ELEM[values.dtype]
    B, M = dest.shape
    row_bytes = elem * math.prod(values.shape[2:])
    out_ptr, values_ptr = out.data_ptr(), values.data_ptr()
    src_ptr = 0 if src is None else src.data_ptr()
    table_elems = out.numel()
    vec_words = table_elems * elem // 16 if word_bytes(out_ptr, src_ptr) == 16 else 0
    word = word_bytes(row_bytes, out_ptr, values_ptr)
    device = values.device
    stream = torch.cuda.current_stream(device).cuda_stream
    args = (out_ptr, src_ptr or None, bits, elem, table_elems, vec_words, dest.data_ptr(),
            dest.element_size(), values_ptr, word, B * M, M, row_bytes // word, size, stream)
    if device.index == torch.cuda.current_device():
        err = _entry(*args)
    else:
        with torch.cuda.device(device):
            err = _entry(*args)
    if err != 0:
        raise RuntimeError(f"gradslam_scatter_rows launch failed: cudaError {err}.")
    if B and M and row_bytes and size:  # the entry point launched scatter_rows
        launches += 1
    return out


def scatter_rows_cuda(size: int, dest: torch.Tensor, values: torch.Tensor, fill=0) -> torch.Tensor:
    r"""A new ``(B, size, *C)`` table filled with ``fill``, with ``values
    (B, M, *C)`` written to rows ``dest (B, M)``, on the card."""
    _on_card(dest, values)
    _check(dest, values)
    if size < 0:
        raise ValueError(f"size must be >= 0. Got {size}.")
    out = torch.empty((dest.shape[0], size) + values.shape[2:], dtype=values.dtype,
                      device=values.device)
    return _launch(out, None, fill_bits(fill, values.dtype), dest, values, size)


def scatter_rows_into_cuda(
    buf: torch.Tensor, dest: torch.Tensor, values: torch.Tensor
) -> torch.Tensor:
    r"""A copy of ``buf (B, S, *C)`` with ``values (B, M, *C)`` written to
    rows ``dest (B, M)``, on the card. ``buf`` itself is not written."""
    _on_card(dest, values, buf)
    _check(dest, values, buf)
    return _launch(torch.empty_like(buf), buf, 0, dest, values, buf.shape[1])
