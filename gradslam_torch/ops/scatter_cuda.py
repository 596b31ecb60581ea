r"""Wrapper of the hand-written CUDA unique-row scatter (``csrc/scatter.cu``).

Same contract as :mod:`gradslam_torch.ops.scatter`, its plain version:
``scatter_rows_cuda`` builds a new ``(B, size, *C)`` table filled with
``fill``, ``scatter_rows_into_cuda`` a copy of an existing buffer; both then
write ``values (B, M, *C)`` to the rows ``dest (B, M)`` names and drop every
destination outside ``[0, size)``. Destinations inside the table must be
unique in each batch row.

The wrapper validates its inputs (CUDA tensors on one device, contiguous,
float32/int32/int64 values, int32/int64 destinations), allocates the output
with ``torch.empty``, launches on PyTorch's current stream and raises if the
launch is refused. A CPU tensor raises here: the dispatchers
:func:`gradslam_torch.structures.pointclouds.scatter_rows` and
``scatter_rows_into`` send those to the plain version, and carry the
gradient.

``launches`` counts the launches of ``scatter_kernel``: one a wrapper call
that has any element to scatter (the call's fill or copy of the table goes
with it), and nowhere else.
"""

from __future__ import annotations

import math

import torch

__all__ = ["scatter_rows_cuda", "scatter_rows_into_cuda", "launches"]

launches = 0

_ELEM = {torch.float32: 4, torch.int32: 4, torch.int64: 8}
_BITS = {4: (torch.int32, 0xFFFFFFFF), 8: (torch.int64, 0xFFFFFFFFFFFFFFFF)}


def _check(dest: torch.Tensor, values: torch.Tensor, others) -> int:
    for name, t in (("dest", dest), ("values", values), *others):
        if not t.is_cuda:
            raise ValueError(f"the scatter kernel takes CUDA tensors; {name} is on {t.device}.")
        if t.device != values.device:
            raise ValueError(f"{name} is on {t.device} but values is on {values.device}.")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous.")
    if dest.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"dest must be int32 or int64. Got {dest.dtype}.")
    if values.dtype not in _ELEM:
        raise ValueError(f"values must be float32, int32 or int64. Got {values.dtype}.")
    if dest.ndim != 2 or values.ndim < 2 or tuple(values.shape[:2]) != tuple(dest.shape):
        raise ValueError(
            f"dest must be (B, M) and values (B, M, *C). Got {tuple(dest.shape)} and "
            f"{tuple(values.shape)}."
        )
    if dest.shape[0] > 65535 or math.prod(values.shape[1:]) >= 2**31:
        raise ValueError(
            f"values {tuple(values.shape)} too large: the kernel takes B <= 65535 and "
            "M * C < 2**31."
        )
    return _ELEM[values.dtype]


def _launch(out, src, fill_bits: int, dest, values, size: int) -> torch.Tensor:
    global launches
    from ._build import load_library

    lib = load_library()
    B, M = dest.shape
    C = math.prod(values.shape[2:])
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.gradslam_scatter_rows(
            out.data_ptr(), None if src is None else src.data_ptr(), fill_bits,
            dest.data_ptr(), dest.element_size(), values.data_ptr(), values.element_size(),
            B, M, C, size, stream,
        )
    if err != 0:
        raise RuntimeError(f"gradslam_scatter_rows launch failed: cudaError {err}.")
    if B and M * C and size:  # the C entry point launched scatter_kernel
        launches += 1
    return out


def scatter_rows_cuda(size: int, dest: torch.Tensor, values: torch.Tensor, fill=0) -> torch.Tensor:
    r"""A new ``(B, size, *C)`` table filled with ``fill``, with ``values
    (B, M, *C)`` written to rows ``dest (B, M)``, on the card."""
    elem = _check(dest, values, ())
    if size < 0:
        raise ValueError(f"size must be >= 0. Got {size}.")
    view, mask = _BITS[elem]
    fill_bits = int(torch.tensor(fill, dtype=values.dtype).view(view).item()) & mask
    out = torch.empty((dest.shape[0], size) + tuple(values.shape[2:]),
                      dtype=values.dtype, device=values.device)
    return _launch(out, None, fill_bits, dest, values, size)


def scatter_rows_into_cuda(
    buf: torch.Tensor, dest: torch.Tensor, values: torch.Tensor
) -> torch.Tensor:
    r"""A copy of ``buf (B, S, *C)`` with ``values (B, M, *C)`` written to
    rows ``dest (B, M)``, on the card. ``buf`` itself is not written."""
    _check(dest, values, (("buf", buf),))
    if buf.dtype != values.dtype:
        raise ValueError(f"buf is {buf.dtype} but values are {values.dtype}.")
    if (buf.ndim != values.ndim or buf.shape[0] != dest.shape[0]
            or buf.shape[2:] != values.shape[2:]):
        raise ValueError(
            f"buf must be (B, S, *C) for values {tuple(values.shape)}. Got {tuple(buf.shape)}."
        )
    return _launch(torch.empty_like(buf), buf, 0, dest, values, buf.shape[1])
