r"""Frame file IO of the PyTorch port: a PNG decoder in the port's own C++
host library, a PNG encoder in ``zlib`` and numpy, the image reader the
dataset loaders use, and the frame loader API of the JAX package's native
library.

Counterpart of the role that ``imageio`` and the native loader
(``gradslam_tpu/datasets/frameio.py``, ``native/``) play for the JAX
package. Neither is assumed here: a machine that runs the port may lack
``imageio`` and the ``libpng`` headers, so PNG frames (TUM and ICL colour
and depth, ScanNet depth and labels) are decoded and encoded by this module
alone.

The decoder reads every colour type and bit depth pair that PNG defines:
grey (colour type 0) at 1, 2, 4, 8 and 16 bits, RGB (2) at 8 and 16,
palette (3) at 1, 2, 4 and 8, grey + alpha (4) and RGBA (6) at 8 and 16,
non-interlaced or Adam7-interlaced. It returns what cv2's
``IMREAD_UNCHANGED`` and imageio return, with the alpha channel stripped:
palette indices are looked up in ``PLTE`` (to RGB; a ``tRNS`` alpha would
only be stripped), grey below 8 bits is scaled to 8 bits (``v * 255 / (2^d
- 1)``), 16-bit samples are big-endian in the file and come out as native
``uint16``. Colour type and bit depth pairs that PNG does not define, and
compression or filter methods other than 0, are refused.

:func:`decode_png` checks the chunks and inflates the image data here
(``zlib`` releases the interpreter lock) and unfilters the rows in the
library (``csrc/frameio.cpp``, one ``ctypes`` call, which releases the lock
too). The library is built from the checkout at first use, never at import,
with the host's C++ compiler (``$CXX``, else ``g++``) into
``gradslam_torch/_build/`` (``ops/_build.py:build_host_library``); a
missing compiler or a failed build raises with the compiler's output, and
nothing falls back to the numpy decoder. :func:`decode_png_plain` is that
decoder, the library's plain version, which the tests hold it against: rows
unfiltered as the PNG specification defines, None, Sub and Up as whole-row
numpy operations, Average and Paeth along anti-diagonals (a wavefront:
pixel ``(y, x)`` needs ``(y, x-1)``, ``(y-1, x)`` and ``(y-1, x-1)``, all
on earlier diagonals), an Adam7 file's seven passes one by one, each as an
image of its own, scattered into the grid.

JPEG (ScanNet's ``color/*.jpg``) is read through Pillow, imported only when a
JPEG is read; where Pillow is missing that read raises ``ImportError``.

The frame loader API (:func:`is_available`, :func:`decode_color`,
:func:`decode_depth`, :class:`FrameLoader`) gives the tensors of
``native/frameio/frameio.cpp`` bit for bit on PNG frames: the library
copies its bilinear colour resize, left unrounded in float32, and its
nearest depth resize times ``1 / depth_scale``, operation for operation
(built with ``-ffp-contract=off`` and without ``-ffast-math`` or
``-march``, so each operation rounds as the JAX package's default x86-64
build rounds it). :func:`_color_arithmetic` and :func:`_depth_arithmetic`
are the same arithmetic in numpy float32, their plain versions.
:class:`FrameLoader` decodes on a pool of threads and starts no process.
"""

from __future__ import annotations

import ctypes
import functools
import os
import struct
import zlib
from pathlib import Path
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

__all__ = [
    "FrameLoader",
    "decode_color",
    "decode_depth",
    "decode_png",
    "decode_png_plain",
    "encode_png",
    "is_available",
    "load_library",
    "read_image",
    "read_png",
    "write_png",
]

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> (samples a pixel, samples kept after the alpha is stripped)
_COLOR_TYPES = {0: (1, 1), 2: (3, 3), 3: (1, 3), 4: (2, 1), 6: (4, 3)}
# colour type -> the bit depths PNG defines for it
_BIT_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# Adam7 passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
          (1, 0, 2, 2), (0, 1, 1, 2))
_COLOR_TYPE_OF_CHANNELS = {1: 0, 2: 4, 3: 2, 4: 6}
FILTER_NONE, FILTER_SUB, FILTER_UP, FILTER_AVERAGE, FILTER_PAETH = range(5)


def _chunks(data: bytes):
    """``(type, payload)`` of each chunk after the signature, CRC-checked."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG file (bad signature)")
    pos = 8
    while pos + 12 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        if pos + 12 + length > len(data):
            raise ValueError(f"truncated PNG file (chunk {kind!r} at byte {pos})")
        payload = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + payload) != crc:
            raise ValueError(f"corrupt PNG chunk {kind!r} at byte {pos}")
        yield kind, payload
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError("truncated PNG file (no IEND chunk)")


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """The Paeth predictor of int16 ``a`` (left), ``b`` (up), ``c``
    (up-left)."""
    pa = np.abs(b - c)
    pb = np.abs(a - c)
    pc = np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter_rows(filt: np.ndarray, types: np.ndarray, bpp: int) -> np.ndarray:
    """Unfilter ``filt (H, stride)`` uint8 when every row is None, Sub or
    Up: one vectorised operation a row."""
    H, stride = filt.shape
    out = np.empty_like(filt)
    prev = np.zeros(stride, dtype=np.uint8)
    for y in range(H):
        row, t = filt[y], types[y]
        if t == FILTER_NONE:
            out[y] = row
        elif t == FILTER_UP:
            out[y] = row + prev  # uint8 wraps mod 256
        else:  # Sub: a running sum of each byte lane, mod 256
            out[y] = np.cumsum(row.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        prev = out[y]
    return out


@functools.lru_cache(maxsize=1)
def _predictor_table() -> np.ndarray:
    """``(5, 511, 511)`` int16: the predictor of each filter type minus the
    up-left byte ``c``, at ``(a - c + 255, b - c + 255)``. Every predictor
    but None's is ``c`` plus a function of ``a - c`` and ``b - c``: Sub
    ``a``, Up ``b``, Average ``(a + b) >> 1 = c + ((da + db) >> 1)``, Paeth
    the one of ``a``, ``b``, ``c`` nearest ``a + b - c``."""
    d = np.arange(-255, 256, dtype=np.int16)
    da, db = np.meshgrid(d, d, indexing="ij")
    zero = np.zeros_like(da)
    c = zero + 255  # any c: the predictors minus c depend on da, db only
    paeth = _paeth(c + da, c + db, c) - c
    return np.stack([zero, da, db, (da + db) >> 1, paeth]).astype(np.int16)


def _unfilter_wavefront(filt: np.ndarray, types: np.ndarray, bpp: int) -> np.ndarray:
    """Unfilter ``filt (H, W * bpp)`` uint8 with any filter types, one
    anti-diagonal of pixels at a time.

    The output lives in a zero-padded ``(H + 1) x (W + 1)`` pixel grid (a
    zero row above, a zero column to the left), flattened: image pixel
    ``(y, x)`` sits at ``(y + 1) * (W + 1) + x + 1``. On diagonal ``t``
    (``x = t - y``) that is ``y * W + t + W + 2``, and the pixel's filtered
    bytes sit at ``y * (W - 1) + t`` of the flattened input: both are
    strided slices, so each step reads and writes views. A step looks its
    predictors up in :func:`_predictor_table` by row type, ``a - c`` and
    ``b - c``; None rows add no ``c``."""
    H, stride = filt.shape
    W = stride // bpp
    table = _predictor_table().reshape(-1)
    # int32: the table index reaches 5 * 511 * 511
    grid = np.zeros(((H + 1) * (W + 1), bpp), dtype=np.int32)
    src = filt.reshape(H * W, bpp).astype(np.int32)
    # each row's offset into the table, with the +255 of both differences
    base = (types.astype(np.int32) * 511 * 511 + 255 * 511 + 255)[:, None]
    keep_c = (types != FILTER_NONE).astype(np.int32)[:, None]
    any_none = not keep_c.all()
    for t in range(H + W - 1):
        y0, y1 = max(0, t - W + 1), min(H - 1, t)
        span = (y1 - y0) * W + 1
        p = y0 * W + t + W + 2  # the diagonal's first pixel in the grid
        c = grid[p - W - 2:p - W - 2 + span:W]
        da = grid[p - 1:p - 1 + span:W] - c
        db = grid[p - W - 1:p - W - 1 + span:W] - c
        pred = table.take(base[y0:y1 + 1] + da * 511 + db)
        pred += c * keep_c[y0:y1 + 1] if any_none else c
        q = y0 * (W - 1) + t
        pred += src[q:q + (y1 - y0) * (W - 1) + 1:W - 1] if W > 1 else src[q:q + 1]
        grid[p:p + span:W] = pred & 0xFF
    out = grid.reshape(H + 1, W + 1, bpp)[1:, 1:]
    return out.astype(np.uint8).reshape(H, stride)


def _stride(width: int, depth: int, color: int) -> int:
    """Bytes of one unfiltered row (the filter-type byte not counted)."""
    return (width * _COLOR_TYPES[color][0] * depth + 7) // 8


def _passes(header: tuple) -> List[tuple]:
    """``(x0, y0, dx, dy, width, height)`` of each non-empty pass: the
    whole image, or the Adam7 passes of an interlaced one."""
    width, height, interlace = header[0], header[1], header[6]
    steps = _ADAM7 if interlace == 1 else ((0, 0, 1, 1),)
    out = []
    for x0, y0, dx, dy in steps:
        w, h = -(-(width - x0) // dx), -(-(height - y0) // dy)
        if w > 0 and h > 0:
            out.append((x0, y0, dx, dy, w, h))
    return out


def _read_chunks(data: bytes) -> tuple:
    """Parse PNG bytes and inflate their image data: ``(header, palette,
    raw)`` with the IHDR fields, the ``PLTE`` entries (``(n, 3)`` uint8, or
    None) and the inflated bytes ``raw`` (``bytes``): each pass's filtered
    rows, each row's filter type first. ``zlib`` releases the interpreter
    lock while it inflates."""
    header, palette, idat = None, None, []
    for kind, payload in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"PLTE":
            palette = np.frombuffer(payload, dtype=np.uint8)[:len(payload) // 3 * 3]
            palette = palette.reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(payload)
    if header is None:
        raise ValueError("PNG file has no IHDR chunk")
    width, height, depth, color, compression, filtering, interlace = header
    if color not in _BIT_DEPTHS or depth not in _BIT_DEPTHS[color]:
        raise ValueError(f"unsupported PNG colour type {color} at bit depth {depth}; "
                         "PNG defines grey (0) at 1, 2, 4, 8, 16 bits, palette (3) at "
                         "1, 2, 4, 8 and RGB (2), grey + alpha (4), RGBA (6) at 8, 16")
    if compression != 0 or filtering != 0 or interlace not in (0, 1):
        raise ValueError(f"unsupported PNG compression {compression}, filter method "
                         f"{filtering} or interlace method {interlace}")
    if color == 3 and palette is None:
        raise ValueError("palette (colour type 3) PNG file has no PLTE chunk")
    return header, palette, zlib.decompress(b"".join(idat))


def _size_error(header: tuple, size: int) -> Optional[ValueError]:
    """The refusal of ``size`` inflated bytes under ``header``, or None
    where the size is the header's."""
    width, height, depth, color = header[:4]
    want = sum(h * (_stride(w, depth, color) + 1) for *_, w, h in _passes(header))
    if size == want:
        return None
    return ValueError(f"PNG image data holds {size} bytes, expected {want} for {width}x{height}")


def _inflate(data: bytes) -> tuple:
    """:func:`_read_chunks` with the inflated bytes as a uint8 array,
    refused unless their size is the header's."""
    header, palette, raw = _read_chunks(data)
    error = _size_error(header, len(raw))
    if error is not None:
        raise error
    return header, palette, np.frombuffer(raw, dtype=np.uint8)


def _samples(rows: np.ndarray, width: int, depth: int, samples: int) -> np.ndarray:
    """Unfiltered rows ``(h, stride)`` to samples ``(h, width, samples)``:
    16-bit big-endian to native ``uint16``, sub-byte samples unpacked (most
    significant bits first), unscaled."""
    h = rows.shape[0]
    if depth == 16:
        return rows.view(">u2").astype(np.uint16).reshape(h, width, samples)
    if depth == 8:
        return rows.reshape(h, width, samples)
    per = 8 // depth
    shifts = (8 - depth - depth * np.arange(per)).astype(np.uint8)
    vals = (rows[..., None] >> shifts) & np.uint8((1 << depth) - 1)
    return vals.reshape(h, -1)[:, :width * samples].reshape(h, width, samples)


def _unfilter_pass(raw: np.ndarray, width: int, height: int, depth: int,
                   color: int) -> np.ndarray:
    """The samples ``(height, width, samples)`` of one pass's filtered
    rows ``raw``."""
    samples = _COLOR_TYPES[color][0]
    bpp = max(1, samples * depth // 8)
    raw = raw.reshape(height, _stride(width, depth, color) + 1)
    if raw[:, 0].max(initial=0) > FILTER_PAETH:
        raise ValueError(f"bad PNG row filter type {int(raw[:, 0].max())}")
    types, filt = raw[:, 0], raw[:, 1:]
    if np.any(types >= FILTER_AVERAGE):
        rows = _unfilter_wavefront(filt, types, bpp)
    else:
        rows = _unfilter_rows(filt, types, bpp)
    return _samples(rows, width, depth, samples)


def _unfilter(header: tuple, palette: Optional[np.ndarray], raw: np.ndarray) -> np.ndarray:
    """The image of inflated bytes (see :func:`_inflate`): palette entries
    looked up, grey below 8 bits scaled to 8 bits, the alpha channel
    stripped, grey as ``(H, W)``."""
    width, height, depth, color = header[:4]
    samples, kept = _COLOR_TYPES[color]
    passes = _passes(header)
    if len(passes) == 1:
        image = _unfilter_pass(raw, width, height, depth, color)
    else:
        image = np.empty((height, width, samples), dtype=np.uint16 if depth == 16 else np.uint8)
        pos = 0
        for x0, y0, dx, dy, w, h in passes:
            n = h * (_stride(w, depth, color) + 1)
            image[y0::dy, x0::dx] = _unfilter_pass(raw[pos:pos + n], w, h, depth, color)
            pos += n
    if color == 3:  # indices past the palette read black, as libpng's do
        table = np.zeros((256, 3), dtype=np.uint8)
        table[:len(palette)] = palette[:256]
        image = table[image[..., 0]]
    elif depth < 8:
        image = image * np.uint8(255 // ((1 << depth) - 1))
    image = image[..., :kept]
    return image[..., 0] if kept == 1 else image


def decode_png_plain(data: bytes) -> np.ndarray:
    r"""The plain version of :func:`decode_png`: the same contract in
    ``zlib`` and numpy alone (the wavefront unfilter). The tests and
    ``chip_smoke.py`` hold the library against it; no loader calls it."""
    return _unfilter(*_inflate(data))


# --------------------------------------------------------------------------- #
# The host library (``csrc/frameio.cpp``), built at first use
# --------------------------------------------------------------------------- #

_CSRC = Path(__file__).resolve().parent / "csrc"
# the library's refusals (csrc/frameio.cpp)
_BAD_FILTER, _BAD_SIZE, _EMPTY = -1, -2, -4


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the frame decoder's library
    (``csrc/frameio.cpp``, with the host's C++ compiler into
    ``gradslam_torch/_build/``); declare its entry points' types. A missing
    compiler or a failed build raises ``RuntimeError`` with the compiler's
    output."""
    from ..ops._build import build_host_library

    lib = ctypes.CDLL(str(build_host_library("gradslam_frameio", [_CSRC / "frameio.cpp"])))
    ci, i64, vp, cp = ctypes.c_int, ctypes.c_int64, ctypes.c_void_p, ctypes.c_char_p
    png = [cp, i64, i64, i64, ci, ci, ci, cp, ci]  # inflated rows, IHDR fields, PLTE
    lib.gradslam_png_decode.argtypes = png + [vp, vp]
    lib.gradslam_png_color.argtypes = png + [ci, ci, ci, vp, vp]
    lib.gradslam_png_depth.argtypes = png + [ci, ci, ctypes.c_float, vp, vp]
    for fn in (lib.gradslam_png_decode, lib.gradslam_png_color, lib.gradslam_png_depth):
        fn.restype = ci
    lib.gradslam_resize_color.argtypes = [vp, i64, i64, ci, ci, ci, ci, vp]
    lib.gradslam_resize_depth.argtypes = [vp, ci, i64, i64, ci, ci, ctypes.c_float, vp]
    lib.gradslam_resize_color.restype = lib.gradslam_resize_depth.restype = None
    return lib


def _png_call(entry, data: bytes, new_out, *args) -> np.ndarray:
    """Parse and inflate PNG ``data`` here, then decode it with the library's
    ``entry`` into ``new_out(header)``'s array (``args`` go between the PNG
    fields and the array) and return the array; raises as
    :func:`decode_png_plain` raises."""
    header, palette, raw = _read_chunks(data)
    width, height, depth, color, _, _, interlace = header
    out = new_out(header)
    pal = b"" if palette is None else palette.tobytes()
    info = (ctypes.c_int64 * 1)()
    code = entry(raw, len(raw), width, height, depth, color, interlace, pal, len(pal) // 3,
                 *args, out.ctypes.data, info)
    if code == _BAD_FILTER:
        raise ValueError(f"bad PNG row filter type {info[0]}")
    if code == _BAD_SIZE:
        raise _size_error(header, len(raw))
    if code == _EMPTY:
        raise ValueError(f"PNG image is empty ({width}x{height}): nothing to resize")
    if code != 0:
        raise ValueError(f"the frame decoder refused PNG header {header} (code {code})")
    return out


def _samples_out(header: tuple) -> np.ndarray:
    """The decoded image's array: ``(H, W)`` or ``(H, W, 3)``, uint8 or
    uint16."""
    width, height, depth, color = header[:4]
    kept = _COLOR_TYPES[color][1]
    return np.empty((height, width) if kept == 1 else (height, width, kept),
                    dtype=np.uint16 if depth == 16 else np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    r"""Decode PNG bytes to ``(H, W)`` (grey) or ``(H, W, 3)`` (colour)
    ``uint8``/``uint16`` samples, the alpha channel stripped: the chunks
    checked and the image data inflated here, the rows unfiltered by the
    library."""
    return _png_call(load_library().gradslam_png_decode, data, _samples_out)


def read_png(path: str) -> np.ndarray:
    """Decode the PNG file at ``path`` (see :func:`decode_png`)."""
    with open(path, "rb") as f:
        return decode_png(f.read())


def _chunk(kind: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + kind + payload
            + struct.pack(">I", zlib.crc32(kind + payload)))


def _filter_rows(raw: np.ndarray, types: np.ndarray, bpp: int) -> np.ndarray:
    """Filter ``raw (H, stride)`` uint8 rows with the per-row ``types``.
    Every predictor reads the unfiltered bytes, so all rows filter at
    once."""
    x = raw.astype(np.int16)
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    left = np.zeros_like(x)
    left[:, bpp:] = x[:, :-bpp]
    upleft = np.zeros_like(x)
    upleft[1:, bpp:] = x[:-1, :-bpp]
    preds = np.stack([np.zeros_like(x), left, up, (left + up) >> 1, _paeth(left, up, upleft)])
    pred = preds[types, np.arange(x.shape[0])]
    return ((x - pred) & 0xFF).astype(np.uint8)


def encode_png(
    image: np.ndarray,
    filters: Union[int, Sequence[int]] = FILTER_PAETH,
    level: int = 6,
) -> bytes:
    r"""Encode ``(H, W)`` or ``(H, W, C)`` (C = 1, 2, 3, 4) ``uint8`` or
    ``uint16`` samples as a non-interlaced PNG.

    ``filters``: the row filter type (0 None, 1 Sub, 2 Up, 3 Average, 4
    Paeth) of every row, or a sequence of types cycled over the rows.
    ``level``: the zlib compression level."""
    image = np.asarray(image)
    if image.dtype not in (np.uint8, np.uint16):
        raise TypeError(f"PNG samples must be uint8 or uint16. Got {image.dtype}.")
    if image.ndim == 2:
        image = image[..., None]
    if image.ndim != 3 or image.shape[-1] not in _COLOR_TYPE_OF_CHANNELS:
        raise ValueError(f"image must have shape (H, W) or (H, W, 1-4). Got {image.shape}.")
    H, W, C = image.shape
    if H < 1 or W < 1:
        raise ValueError(f"image must not be empty. Got {image.shape}.")
    depth = 8 * image.dtype.itemsize
    raw = np.ascontiguousarray(image.astype(">u2") if depth == 16 else image)
    raw = raw.view(np.uint8).reshape(H, W * C * depth // 8)
    cycle = np.atleast_1d(np.asarray(filters, dtype=np.int64))
    if cycle.size == 0 or cycle.min() < 0 or cycle.max() > FILTER_PAETH:
        raise ValueError(f"filter types must be in 0-4. Got {filters!r}.")
    types = cycle[np.arange(H) % cycle.size]
    rows = np.concatenate(
        [types.astype(np.uint8)[:, None], _filter_rows(raw, types, C * depth // 8)], axis=1)
    header = struct.pack(">IIBBBBB", W, H, depth, _COLOR_TYPE_OF_CHANNELS[C], 0, 0, 0)
    return b"".join([PNG_SIGNATURE, _chunk(b"IHDR", header),
                     _chunk(b"IDAT", zlib.compress(rows.tobytes(), level)),
                     _chunk(b"IEND", b"")])


def write_png(
    path: str,
    image: np.ndarray,
    filters: Union[int, Sequence[int]] = FILTER_PAETH,
    level: int = 6,
) -> None:
    """Encode ``image`` (see :func:`encode_png`) and write it to ``path``."""
    data = encode_png(image, filters, level)
    with open(path, "wb") as f:
        f.write(data)


def read_image(path: str) -> np.ndarray:
    r"""Read a frame file: PNG through :func:`read_png`, JPEG through
    Pillow. Other suffixes are refused."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".png":
        return read_png(path)
    if ext in (".jpg", ".jpeg"):
        try:
            from PIL import Image
        except ImportError as e:
            raise ImportError(
                f"reading {path} needs a JPEG decoder: the port reads JPEG through "
                "Pillow (the PIL package), which is not installed") from e
        with Image.open(path) as im:
            return np.asarray(im)
    raise ValueError(f"unsupported frame file type {ext!r} ({path}); expected .png or .jpg")


# --------------------------------------------------------------------------- #
# The frame loader API of ``native/frameio/frameio.cpp``
# --------------------------------------------------------------------------- #

_DECODE_ERRORS = (OSError, ValueError, EOFError, struct.error, zlib.error)


def is_available() -> bool:
    """True when the frame decoder's library is built and loads. It is built
    here at first use, so this may take the compiler's few seconds; a
    missing compiler or a failed build gives False (and
    :func:`load_library` the compiler's output)."""
    try:
        load_library()
    except (RuntimeError, OSError):
        return False
    return True


def _f32(x) -> np.float32:
    return np.float32(x)


def _bilinear_taps(src: int, dst: int):
    """``libframeio``'s bilinear sample positions along one axis, in
    float32: ``f = (i + 0.5f) * (src / dst) - 0.5f``, the low index
    ``(int)f`` (``f`` clamped at 0 first), the high one clamped to ``src -
    1`` and the weight ``f - low``."""
    s = _f32(src) / _f32(dst)
    f = (np.arange(dst, dtype=np.float32) + _f32(0.5)) * s - _f32(0.5)
    neg = f < 0
    f = np.where(neg, _f32(0.0), f)
    lo = f.astype(np.int64)
    hi = np.where(lo + 1 < src, lo + 1, src - 1)
    return lo, hi, f - lo.astype(np.float32)


def _color_arithmetic(image: np.ndarray, height: int, width: int,
                     normalize: bool = False) -> np.ndarray:
    r"""``libframeio``'s colour resize of decoded samples ``image (h, w)``
    or ``(h, w, C)`` to ``(height, width, 3)`` float32
    (``native/frameio/frameio.cpp:134-166``): bilinear with cv2's sample
    positions, the sum ``v00 (1 - wy)(1 - wx) + v01 (1 - wy) wx + v10 wy
    (1 - wx) + v11 wy wx`` in that order and left unrounded, times ``1.0f /
    255`` when normalizing. A grey image is broadcast to 3 channels. The
    library reads bytes: 16-bit samples are read as the little-endian
    bytes it decodes them to, as it does."""
    img = np.asarray(image)
    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else img.shape[2]
    flat = np.ascontiguousarray(img, dtype="<u2" if img.dtype == np.uint16 else np.uint8)
    flat = flat.view(np.uint8).reshape(-1)
    y0, y1, wy = _bilinear_taps(h, height)
    x0, x1, wx = _bilinear_taps(w, width)
    k = np.arange(3) if ch >= 3 else np.zeros(3, dtype=np.int64)

    def at(ys, xs):
        return flat[((ys[:, None] * w + xs[None, :]) * ch)[..., None] + k].astype(np.float32)

    one = _f32(1.0)
    if wy.any() or wx.any():
        wy, wx = wy[:, None, None], wx[None, :, None]
        out = (at(y0, x0) * (one - wy) * (one - wx) + at(y0, x1) * (one - wy) * wx
               + at(y1, x0) * wy * (one - wx) + at(y1, x1) * wy * wx)
    else:  # every weight 0 (the stored size): the sum is v00 + 0 + 0 + 0, exactly
        out = at(y0, x0)
    return out * (one / _f32(255.0)) if normalize else out


def _depth_arithmetic(image: np.ndarray, height: int, width: int,
                     depth_scale: float) -> np.ndarray:
    r"""``libframeio``'s depth resize of decoded samples to ``(height,
    width)`` float32 metres (``native/frameio/frameio.cpp:168-190``): the
    nearest sample at ``(int)(y * (h / height))``, clamped to the last
    row, read from the samples in order, times ``1.0f / depth_scale`` (the
    scale a C ``float``), for 16-bit and 8-bit depth alike."""
    img = np.asarray(image)
    h, w = img.shape[:2]
    flat = img.reshape(-1)
    ys = np.minimum((np.arange(height, dtype=np.float32) * (_f32(h) / _f32(height)))
                    .astype(np.int64), h - 1)
    xs = np.minimum((np.arange(width, dtype=np.float32) * (_f32(w) / _f32(width)))
                    .astype(np.int64), w - 1)
    values = flat[ys[:, None] * w + xs[None, :]].astype(np.float32)
    return values * (_f32(1.0) / _f32(depth_scale))


def _resized(path: str, shape: tuple, color: bool, arg) -> Optional[np.ndarray]:
    """Frame file ``path`` decoded and resized by the library to a new
    float32 array of ``shape``, or None where decoding fails: PNG in one
    library call (colour: ``arg`` is ``normalize``; depth: the depth scale),
    JPEG (a ``.jpg``/``.jpeg`` suffix, any case) decoded by Pillow and its
    samples resized by the library. A library that cannot be built raises."""
    lib = load_library()
    H, W = shape[:2]
    arg = int(arg) if color else float(arg)
    try:
        if os.path.splitext(path)[1].lower() not in (".jpg", ".jpeg"):
            with open(path, "rb") as f:
                data = f.read()
            entry = lib.gradslam_png_color if color else lib.gradslam_png_depth
            return _png_call(entry, data, lambda header: np.empty(shape, dtype=np.float32),
                             H, W, arg)
        image = np.asarray(read_image(path))
        h, w = image.shape[:2]
        if h < 1 or w < 1:
            return None
        is16 = image.dtype == np.uint16
        data = np.ascontiguousarray(image, dtype="<u2" if is16 else np.uint8)
        out = np.empty(shape, dtype=np.float32)
        if color:
            ch = 1 if image.ndim == 2 else image.shape[2]
            lib.gradslam_resize_color(data.ctypes.data, h, w, ch, H, W, arg, out.ctypes.data)
        else:
            lib.gradslam_resize_depth(data.ctypes.data, int(is16), h, w, H, W, arg,
                                      out.ctypes.data)
        return out
    except _DECODE_ERRORS:
        return None


def decode_color(path: str, height: int, width: int,
                 normalize: bool = False) -> Optional[np.ndarray]:
    """Decode and bilinear-resize a PNG/JPEG colour image to ``(H, W, 3)``
    float32 with ``libframeio``'s arithmetic, in the library
    (:func:`_color_arithmetic` is its plain version); None when decoding
    fails."""
    return _resized(path, (height, width, 3), True, normalize)


def decode_depth(path: str, height: int, width: int,
                 depth_scale: float) -> Optional[np.ndarray]:
    """Decode and nearest-resize a 16-bit (or 8-bit) depth image to ``(H,
    W)`` float32 metres with ``libframeio``'s arithmetic, in the library
    (:func:`_depth_arithmetic` is its plain version); None when decoding
    fails."""
    return _resized(path, (height, width), False, depth_scale)


def _decode_frame(color_path: str, depth_path: str, height: int, width: int,
                  depth_scale: float, normalize: bool):
    """One frame on a loader thread: ``(rgb, depth)``, or None if either
    file fails to decode."""
    rgb = decode_color(color_path, height, width, normalize)
    depth = decode_depth(depth_path, height, width, depth_scale)
    return None if rgb is None or depth is None else (rgb, depth)


class FrameLoader:
    r"""Prefetching frame loader over a pool of ``num_threads`` threads, as
    the JAX package's native loader (4 by default). Each thread reads a
    file, inflates it with ``zlib`` and decodes and resizes it in one call
    into the library; all three release the interpreter lock, so the
    threads decode in parallel. It starts no process.

    Example::

        loader = FrameLoader(height=480, width=640, depth_scale=5000.0)
        loader.submit_sequence(color_paths, depth_paths)
        rgb, depth = loader.fetch(0)   # (H, W, 3) f32, (H, W) f32 meters
        loader.close()
    """

    def __init__(
        self,
        height: int,
        width: int,
        depth_scale: float,
        normalize_color: bool = False,
        num_threads: int = 4,
    ):
        import concurrent.futures

        load_library()  # a library that cannot be built raises here
        self.height = height
        self.width = width
        self.depth_scale = float(depth_scale)
        self.normalize_color = bool(normalize_color)
        self._futures = {}
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=num_threads if num_threads > 0 else 4, thread_name_prefix="frameio")

    def submit(self, index: int, color_path: str, depth_path: str):
        """Queue one frame (color+depth paths) for background decoding."""
        if self._pool is None:
            raise RuntimeError("FrameLoader is closed")
        self._futures[index] = self._pool.submit(
            _decode_frame, color_path, depth_path, self.height, self.width,
            self.depth_scale, self.normalize_color)

    def submit_sequence(self, color_paths: Sequence[str], depth_paths: Sequence[str]):
        """Queue a whole sequence; frame ``i`` is fetched by index ``i``."""
        for i, (c, d) in enumerate(zip(color_paths, depth_paths)):
            self.submit(i, c, d)

    def fetch(self, index: int) -> Tuple[np.ndarray, np.ndarray]:
        """Block until frame ``index`` is decoded; returns ``(rgb (H, W, 3),
        depth (H, W))`` float32. A frame is fetched once, in any order."""
        future = self._futures.pop(index, None)
        if future is None:
            raise IOError(f"frameio has no frame {index} queued")
        result = future.result()
        if result is None:
            raise IOError(f"frameio failed to load frame {index}")
        return result

    def close(self):
        """Stop the threads (queued frames are dropped); safe to call more
        than once."""
        pool, self._pool = getattr(self, "_pool", None), None
        if pool is not None:
            pool.shutdown(wait=True, cancel_futures=True)
        self._futures = {}

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
