"""A small PNG writer for the decoder tests: any colour type and bit depth,
Adam7 passes, a PLTE and a tRNS chunk. Neither Pillow nor cv2 writes
Adam7, grey at 2 or 4 bits, or a chosen filter per row."""

import struct
import zlib

import numpy as np

from gradslam_torch.datasets import frameio

ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
         (1, 0, 2, 2), (0, 1, 1, 2))


def _chunk(kind: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + kind + payload
            + struct.pack(">I", zlib.crc32(kind + payload)))


def _rows(img: np.ndarray, depth: int, filters) -> bytes:
    """One image's (or pass's) filtered rows, filter type byte first."""
    h, w, c = img.shape
    if depth == 16:
        raw = img.astype(">u2").view(np.uint8).reshape(h, -1)
    elif depth == 8:
        raw = img.astype(np.uint8).reshape(h, -1)
    else:  # pack sub-byte samples, most significant bits first
        per = 8 // depth
        v = img.reshape(h, -1).astype(np.uint8)
        v = np.pad(v, ((0, 0), (0, (-v.shape[1]) % per))).reshape(h, -1, per)
        shifts = (8 - depth - depth * np.arange(per)).astype(np.uint8)
        raw = np.bitwise_or.reduce(v << shifts, axis=-1).astype(np.uint8)
    types = np.asarray(filters)[np.arange(h) % len(filters)]
    filt = frameio._filter_rows(raw, types, max(1, c * depth // 8))
    return np.concatenate([types.astype(np.uint8)[:, None], filt], axis=1).tobytes()


def png_bytes(samples, color: int, depth: int, interlace: bool = False, palette=None,
              trns: bytes = None, filters=(0, 1, 2, 3, 4)) -> bytes:
    """A PNG of ``samples`` ``(H, W)`` or ``(H, W, C)`` (values at
    ``depth`` bits; palette indices for colour type 3)."""
    samples = np.asarray(samples)
    samples = samples if samples.ndim == 3 else samples[..., None]
    H, W = samples.shape[:2]
    if interlace:
        data = b"".join(_rows(samples[y0::dy, x0::dx], depth, filters)
                        for x0, y0, dx, dy in ADAM7 if samples[y0::dy, x0::dx].size)
    else:
        data = _rows(samples, depth, filters)
    out = frameio.PNG_SIGNATURE + _chunk(
        b"IHDR", struct.pack(">IIBBBBB", W, H, depth, color, 0, 0, int(interlace)))
    if palette is not None:
        out += _chunk(b"PLTE", np.asarray(palette, dtype=np.uint8).tobytes())
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    return out + _chunk(b"IDAT", zlib.compress(data)) + _chunk(b"IEND", b"")


def write(path, *args, **kwargs) -> str:
    with open(path, "wb") as f:
        f.write(png_bytes(*args, **kwargs))
    return str(path)
