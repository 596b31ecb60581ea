r"""Frame file IO of the PyTorch port: a PNG codec built from ``zlib`` and
numpy, and the image reader the dataset loaders use.

Counterpart of the role that ``imageio`` and the native loader
(``gradslam_tpu/datasets/frameio.py``, ``native/``) play for the JAX
package. Neither is assumed here: a machine that runs the port may lack
``imageio`` and the ``libpng`` headers, so PNG frames (TUM and ICL colour
and depth, ScanNet depth and labels) are decoded and encoded by this module
alone.

The decoder reads non-interlaced PNGs of colour types 0 (grey), 2 (RGB), 4
(grey + alpha) and 6 (RGBA) at bit depths 8 and 16; the alpha channel is
stripped. 16-bit samples are big-endian in the file and come out as native
``uint16``. Rows are unfiltered as the PNG specification defines: None, Sub
and Up are whole-row numpy operations; Average and Paeth read the pixel to
the left, so an image that uses them is unfiltered along anti-diagonals (a
wavefront: pixel ``(y, x)`` needs ``(y, x-1)``, ``(y-1, x)`` and
``(y-1, x-1)``, all on earlier diagonals), ``H + W - 1`` vectorised steps
instead of ``H * W`` scalar ones. Adam7-interlaced and palette files are refused with an
error that names them.

JPEG (ScanNet's ``color/*.jpg``) is read through Pillow, imported only when a
JPEG is read; where Pillow is missing that read raises ``ImportError``.
"""

from __future__ import annotations

import functools
import os
import struct
import zlib
from typing import List, Sequence, Union

import numpy as np

__all__ = ["decode_png", "encode_png", "read_image", "read_images", "read_png", "write_png"]

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> (samples a pixel, samples kept after the alpha is stripped)
_COLOR_TYPES = {0: (1, 1), 2: (3, 3), 4: (2, 1), 6: (4, 3)}
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
        payload = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if len(payload) != length or zlib.crc32(kind + payload) != crc:
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


def _inflate(data: bytes) -> tuple:
    """Parse and inflate PNG bytes: ``(header, raw)`` with the IHDR fields
    and the filtered rows ``(H, 1 + W * bpp)`` uint8 (each row's filter type
    first). ``zlib`` releases the interpreter lock while it inflates."""
    header, idat = None, []
    for kind, payload in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"IDAT":
            idat.append(payload)
    if header is None:
        raise ValueError("PNG file has no IHDR chunk")
    width, height, depth, color, compression, filtering, interlace = header
    if interlace == 1:
        raise ValueError("Adam7-interlaced PNG files are not supported; "
                         "re-save the image without interlacing")
    if color == 3:
        raise ValueError("palette (colour type 3) PNG files are not supported")
    if color not in _COLOR_TYPES or depth not in (8, 16):
        raise ValueError(f"unsupported PNG colour type {color} at bit depth {depth}; "
                         "supported: colour types 0, 2, 4, 6 at bit depth 8 or 16")
    if compression != 0 or filtering != 0 or interlace != 0:
        raise ValueError(f"unsupported PNG compression {compression}, filter method "
                         f"{filtering} or interlace method {interlace}")
    stride = width * _COLOR_TYPES[color][0] * depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), dtype=np.uint8)
    if raw.size != height * (stride + 1):
        raise ValueError(f"PNG image data holds {raw.size} bytes, expected "
                         f"{height * (stride + 1)} for {width}x{height}")
    raw = raw.reshape(height, stride + 1)
    if raw[:, 0].max(initial=0) > FILTER_PAETH:
        raise ValueError(f"bad PNG row filter type {int(raw[:, 0].max())}")
    return header, raw


def _pixels(header: tuple, rows: np.ndarray) -> np.ndarray:
    """Unfiltered rows to samples: 16-bit big-endian to native ``uint16``,
    the alpha channel stripped, grey as ``(H, W)``."""
    width, height, depth, color = header[:4]
    samples, kept = _COLOR_TYPES[color]
    pixels = rows.view(">u2").astype(np.uint16) if depth == 16 else rows
    pixels = pixels.reshape(height, width, samples)[..., :kept]
    return pixels[..., 0] if kept == 1 else pixels


def _unfilter(header: tuple, raw: np.ndarray) -> np.ndarray:
    """The samples of inflated rows (see :func:`_inflate`)."""
    width, height, depth, color = header[:4]
    bpp = _COLOR_TYPES[color][0] * depth // 8
    types, filt = raw[:, 0], raw[:, 1:]
    if np.any(types >= FILTER_AVERAGE):
        return _pixels(header, _unfilter_wavefront(filt, types, bpp))
    return _pixels(header, _unfilter_rows(filt, types, bpp))


def decode_png(data: bytes) -> np.ndarray:
    r"""Decode PNG bytes to ``(H, W)`` (grey) or ``(H, W, 3)`` (colour)
    ``uint8``/``uint16`` samples, the alpha channel stripped."""
    return _unfilter(*_inflate(data))


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


def _is_png(path: str) -> bool:
    return os.path.splitext(path)[1].lower() == ".png"


def _read_and_inflate(path: str):
    """A PNG file read and inflated (``(header, raw)``), any other frame
    file read whole (:func:`read_image`)."""
    if _is_png(path):
        with open(path, "rb") as f:
            return _inflate(f.read())
    return read_image(path)


def read_images(paths: Sequence[str], pool=None) -> List[np.ndarray]:
    r"""Read several frame files as :func:`read_image` reads each. With
    ``pool`` (a ``concurrent.futures`` executor) the files are read and
    inflated on it, where ``zlib`` (and Pillow's JPEG decoder) release the
    interpreter lock; a PNG's rows are then unfiltered in this thread, one
    file after the other, since that work holds the lock and threads
    running it slow each other down."""
    loaded = pool.map(_read_and_inflate, paths) if pool is not None else map(
        _read_and_inflate, paths)
    return [_unfilter(*item) if _is_png(path) else item for path, item in zip(paths, loaded)]


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
