"""The port's PNG codec (``gradslam_torch/datasets/frameio.py``) against
imageio and cv2, the readers and writers the JAX package's loaders and tests
use: decoding is bit for bit, on files that imageio (Pillow, which picks
each row's filter adaptively), cv2 (Sub rows by default, every filter
adaptively when asked) and the port wrote; the port's files read
back bit for bit through imageio; a per-pixel loop that follows the PNG
specification's unfiltering holds the wavefront decoder on every filter
type; every colour type and bit depth pair PNG defines, palette files and
Adam7 files decode as cv2 reads them."""

import struct
import zlib

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")
imageio = pytest.importorskip("imageio.v2")

from gradslam_torch.datasets import frameio  # noqa: E402

from . import _pngfiles  # noqa: E402


def _images():
    rng = np.random.RandomState(0)
    yy, xx = np.mgrid[:40, :56]
    return {
        "rgb8": (rng.rand(48, 64, 3) * 256).astype(np.uint8),
        "gray16": (rng.rand(48, 64) * 65536).astype(np.uint16),
        "gray8": (rng.rand(31, 7) * 256).astype(np.uint8),
        "rgba8": (rng.rand(17, 23, 4) * 256).astype(np.uint8),
        "graya8": (rng.rand(9, 13, 2) * 256).astype(np.uint8),
        "rgb16": (rng.rand(11, 12, 3) * 65536).astype(np.uint16),
        # smooth ramps: adaptive writers pick Average and Paeth rows here
        "smooth_rgb8": np.stack([(xx + yy) % 256, (2 * xx) % 256, (3 * yy) % 256],
                                -1).astype(np.uint8),
        "smooth_gray16": ((300 * xx + 17 * yy) % 65536).astype(np.uint16),
        "one_column": (rng.rand(5, 1, 3) * 256).astype(np.uint8),
    }


IMAGES = _images()


def _expected(img):
    """What the decoder returns: the alpha stripped, grey as (H, W)."""
    if img.ndim == 3 and img.shape[-1] in (2, 4):
        img = img[..., :-1]
    return img[..., 0] if img.ndim == 3 and img.shape[-1] == 1 else img


def _write_cv2(path, img, adaptive=False):
    flags = [cv2.IMWRITE_PNG_FILTER, cv2.IMWRITE_PNG_ALL_FILTERS] if adaptive else []
    if img.ndim == 3 and img.shape[-1] == 3:
        img = cv2.cvtColor(img, cv2.COLOR_RGB2BGR)
    elif img.ndim == 3 and img.shape[-1] == 4:
        img = cv2.cvtColor(img, cv2.COLOR_RGBA2BGRA)
    assert cv2.imwrite(path, img, flags)


def _read_cv2(path):
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img.ndim == 3 and img.shape[-1] == 3:
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    if img.ndim == 3 and img.shape[-1] == 4:
        return cv2.cvtColor(img, cv2.COLOR_BGRA2RGB)
    return img


def _filter_types(data: bytes) -> set:
    """The row filter types a (non-interlaced) PNG file uses."""
    pos, idat, header = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, payload = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"IDAT":
            idat.append(payload)
        pos += 12 + n
    H = header[1]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    return set(raw.reshape(H, -1)[:, 0].tolist())


WRITERS = ("imageio", "cv2", "cv2_adaptive", "port")
# imageio (Pillow) writes no 16-bit colour and cv2 no grey + alpha
CASES = [(name, w) for name in IMAGES for w in WRITERS
         if not (w == "imageio" and name == "rgb16")
         and not (w.startswith("cv2") and name == "graya8")]


@pytest.mark.parametrize("name,writer", CASES)
def test_decoder_equals_the_reference_reader_bit_for_bit(tmp_path, name, writer):
    """Exact: the same dtype, shape and samples as the reference reader
    (imageio, or cv2 for 16-bit colour, which imageio reduces to 8 bits)
    and as the array written."""
    img = IMAGES[name]
    path = str(tmp_path / f"{name}.png")
    if writer == "imageio":
        imageio.imwrite(path, img)
    elif writer.startswith("cv2"):
        _write_cv2(path, img, adaptive=writer == "cv2_adaptive")
    else:
        frameio.write_png(path, img, filters=(0, 1, 2, 3, 4))
    got = frameio.read_png(path)
    ref = _read_cv2(path) if name == "rgb16" else _expected(np.asarray(imageio.imread(path)))
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, _expected(img))


def test_adaptive_writers_use_the_slow_filters(tmp_path):
    """The cases above reach every filter type in files that the reference
    writers chose them for: cv2's adaptive filtering writes all five row
    types, Pillow's at least Paeth."""
    for writer, want in (("cv2_adaptive", {0, 1, 2, 3, 4}), ("imageio", {4})):
        path = str(tmp_path / f"{writer}.png")
        if writer == "imageio":
            imageio.imwrite(path, IMAGES["rgb8"])
        else:
            _write_cv2(path, IMAGES["rgb8"], adaptive=True)
        with open(path, "rb") as f:
            assert want <= _filter_types(f.read()), writer


@pytest.mark.parametrize("filters", [0, 1, 2, 3, 4, (4, 3, 2, 1, 0), (3, 3, 0, 4)])
@pytest.mark.parametrize("name", ["rgb8", "gray16", "rgba8"])
def test_encoder_round_trips_through_imageio(tmp_path, name, filters):
    """Exact: the port's file, with every filter type and mixes of them,
    reads back through imageio as the array written (alpha kept), and the
    file uses the filter types asked for."""
    img = IMAGES[name]
    path = str(tmp_path / "out.png")
    frameio.write_png(path, img, filters=filters)
    back = np.asarray(imageio.imread(path))
    assert back.dtype == img.dtype
    np.testing.assert_array_equal(back, img)
    with open(path, "rb") as f:
        assert _filter_types(f.read()) == set(np.atleast_1d(filters).tolist())


def test_16bit_depth_is_big_endian(tmp_path):
    """A 16-bit sample 0x0102 is stored as the bytes 01 02 and decodes to
    258, not 513; depth / 5000 reads metres."""
    depth = np.array([[258, 7500], [65535, 1]], dtype=np.uint16)
    data = frameio.encode_png(depth, filters=0)
    idat = data[data.index(b"IDAT") + 4:]
    raw = zlib.decompressobj().decompress(idat)
    assert raw[:5] == bytes([0, 0x01, 0x02, 0x1D, 0x4C])
    out = frameio.decode_png(data)
    assert out.dtype == np.uint16
    np.testing.assert_array_equal(out, depth)
    path = str(tmp_path / "d.png")
    imageio.imwrite(path, depth)
    np.testing.assert_array_equal(frameio.read_png(path), depth)
    assert float(frameio.read_png(path)[0, 1]) / 5000.0 == 1.5


def _with_header_byte(data: bytes, offset: int, value: int) -> bytes:
    """``data`` with IHDR payload byte ``offset`` set and the CRC redone."""
    pos = data.index(b"IHDR")
    payload = bytearray(data[pos + 4:pos + 17])
    payload[offset] = value
    crc = struct.pack(">I", zlib.crc32(b"IHDR" + bytes(payload)))
    return data[:pos + 4] + bytes(payload) + crc + data[pos + 21:]


def test_undefined_formats_raise():
    """Colour type and bit depth pairs that PNG does not define, and
    methods other than 0, are refused; so are corrupt files. The header of a
    valid file is edited (CRC redone)."""
    data = frameio.encode_png(IMAGES["rgb8"])
    with pytest.raises(ValueError, match="colour type 2 at bit depth 4"):
        frameio.decode_png(_with_header_byte(data, 8, 4))
    with pytest.raises(ValueError, match="colour type 3 at bit depth 16"):
        frameio.decode_png(_with_header_byte(_with_header_byte(data, 9, 3), 8, 16))
    with pytest.raises(ValueError, match="colour type 5"):
        frameio.decode_png(_with_header_byte(data, 9, 5))
    with pytest.raises(ValueError, match="compression 1"):
        frameio.decode_png(_with_header_byte(data, 10, 1))
    with pytest.raises(ValueError, match="filter method 1"):
        frameio.decode_png(_with_header_byte(data, 11, 1))
    with pytest.raises(ValueError, match="interlace method 2"):
        frameio.decode_png(_with_header_byte(data, 12, 2))
    with pytest.raises(ValueError, match="no PLTE"):
        frameio.decode_png(_with_header_byte(frameio.encode_png(IMAGES["gray8"]), 9, 3))
    with pytest.raises(ValueError, match="expected"):  # an interlaced header on plain rows
        frameio.decode_png(_with_header_byte(data, 12, 1))
    with pytest.raises(ValueError, match="corrupt"):
        frameio.decode_png(data[:40] + bytes([data[40] ^ 1]) + data[41:])
    with pytest.raises(ValueError, match="signature"):
        frameio.decode_png(b"GIF89a" + data[6:])


def _cv2_rgb(path):
    """cv2's ``IMREAD_UNCHANGED`` read as the decoder returns it: RGB, the
    alpha stripped."""
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img.ndim == 3:
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB if img.shape[-1] == 3 else cv2.COLOR_BGRA2RGB)
    return img


_RNG = np.random.RandomState(5)
_PALETTE = _RNG.randint(0, 256, (256, 3))
# name -> (samples, colour type, bit depth, palette); odd sizes leave Adam7
# passes partial (and empty at 1x1)
FORMATS = {
    "gray1": (_RNG.randint(0, 2, (37, 53)), 0, 1, None),
    "gray2": (_RNG.randint(0, 4, (37, 53)), 0, 2, None),
    "gray4": (_RNG.randint(0, 16, (37, 53)), 0, 4, None),
    "pal1": (_RNG.randint(0, 2, (13, 21)), 3, 1, _PALETTE[:2]),
    "pal2": (_RNG.randint(0, 4, (13, 21)), 3, 2, _PALETTE[:4]),
    "pal4": (_RNG.randint(0, 16, (37, 53)), 3, 4, _PALETTE[:16]),
    "pal8": (_RNG.randint(0, 200, (37, 53)), 3, 8, _PALETTE[:200]),
    "rgb8": (_RNG.randint(0, 256, (37, 53, 3)), 2, 8, None),
    "rgb16": (_RNG.randint(0, 65536, (11, 12, 3)), 2, 16, None),
    "gray16": (_RNG.randint(0, 65536, (37, 53)), 0, 16, None),
    "graya8": (_RNG.randint(0, 256, (9, 13, 2)), 4, 8, None),
    "rgba16": (_RNG.randint(0, 65536, (9, 10, 4)), 6, 16, None),
    "one_pixel": (_RNG.randint(0, 256, (1, 1, 3)), 2, 8, None),
}


@pytest.mark.parametrize("interlace", [False, True])
@pytest.mark.parametrize("name", sorted(FORMATS))
def test_every_png_format_decodes_as_cv2_reads_it(tmp_path, name, interlace):
    """Grey at 1, 2 and 4 bits (scaled to 8 bits), palette files at every
    depth (looked up to RGB) and Adam7 files of every colour type (the seven
    passes unfiltered one by one, every filter type on their rows): bit for
    bit what cv2's ``IMREAD_UNCHANGED`` reads, the alpha stripped."""
    samples, color, depth, palette = FORMATS[name]
    path = _pngfiles.write(tmp_path / f"{name}.png", samples, color, depth,
                           interlace=interlace, palette=palette)
    got, ref = frameio.read_png(path), _cv2_rgb(path)
    if color == 4:  # cv2 reads grey + alpha as BGRA with the grey repeated
        assert (ref == ref[..., :1]).all()
        ref = ref[..., 0]
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    if color == 3:
        np.testing.assert_array_equal(got, np.asarray(palette, np.uint8)[samples])
    elif depth < 8:
        np.testing.assert_array_equal(got, samples * (255 // ((1 << depth) - 1)))


def test_pillow_palette_and_1bit_files_equal_cv2_and_imageio(tmp_path):
    """Files Pillow writes: palette PNGs at 8 and 4 bits (with a tRNS alpha,
    which is stripped) and a 1-bit grey PNG (imageio reads it as bool)."""
    from PIL import Image

    rgb = (np.random.RandomState(1).rand(20, 30, 3) * 256).astype(np.uint8)
    pal = Image.fromarray(rgb).quantize(16)
    pal.save(str(tmp_path / "p8.png"))
    pal.save(str(tmp_path / "p4.png"), bits=4)
    pal.save(str(tmp_path / "pt.png"), transparency=3)
    bits = np.random.RandomState(2).rand(20, 30) > 0.5
    Image.fromarray(bits).save(str(tmp_path / "b1.png"))
    assert frameio._inflate(open(tmp_path / "p4.png", "rb").read())[0][2:4] == (4, 3)
    for name in ("p8", "p4", "pt"):
        path = str(tmp_path / f"{name}.png")
        got = frameio.read_png(path)
        np.testing.assert_array_equal(got, _cv2_rgb(path))
        np.testing.assert_array_equal(got, np.asarray(imageio.imread(path))[..., :3])
    path = str(tmp_path / "b1.png")
    assert frameio._inflate(open(path, "rb").read())[0][2:4] == (1, 0)
    np.testing.assert_array_equal(frameio.read_png(path), _cv2_rgb(path))
    np.testing.assert_array_equal(frameio.read_png(path),
                                  np.asarray(imageio.imread(path)).astype(np.uint8) * 255)


def _unfilter_loop(filt, types, bpp):
    """The PNG specification's unfiltering, one byte at a time."""
    H, stride = filt.shape
    out = np.zeros((H, stride), dtype=np.int64)
    for y in range(H):
        for i in range(stride):
            a = int(out[y, i - bpp]) if i >= bpp else 0
            b = int(out[y - 1, i]) if y > 0 else 0
            c = int(out[y - 1, i - bpp]) if y > 0 and i >= bpp else 0
            t = types[y]
            if t == 0:
                pred = 0
            elif t == 1:
                pred = a
            elif t == 2:
                pred = b
            elif t == 3:
                pred = (a + b) // 2
            else:
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            out[y, i] = (int(filt[y, i]) + pred) % 256
    return out.astype(np.uint8)


@pytest.mark.parametrize("bpp,shape", [(3, (9, 11)), (2, (7, 5)), (1, (6, 1)), (4, (1, 8))])
def test_wavefront_unfilter_equals_the_byte_loop(bpp, shape):
    """Exact, on random filtered bytes with random filter types per row."""
    rng = np.random.RandomState(bpp)
    H, W = shape
    filt = rng.randint(0, 256, (H, W * bpp)).astype(np.uint8)
    types = rng.randint(0, 5, H).astype(np.uint8)
    ref = _unfilter_loop(filt, types, bpp)
    np.testing.assert_array_equal(frameio._unfilter_wavefront(filt, types, bpp), ref)
    easy = np.where(types >= 3, 1, types).astype(np.uint8)
    np.testing.assert_array_equal(frameio._unfilter_rows(filt, easy, bpp),
                                  _unfilter_loop(filt, easy, bpp))


def test_read_image_jpeg_equals_imageio(tmp_path):
    """JPEG goes through Pillow: bit for bit what imageio (Pillow's plugin)
    reads, which is what the JAX ScanNet loader reads."""
    pytest.importorskip("PIL")
    path = str(tmp_path / "c.jpg")
    imageio.imwrite(path, IMAGES["rgb8"])
    got = frameio.read_image(path)
    np.testing.assert_array_equal(got, np.asarray(imageio.imread(path)))
    with pytest.raises(ValueError, match="unsupported frame file type"):
        frameio.read_image(str(tmp_path / "c.bmp"))


def test_read_image_without_pillow_names_it(tmp_path, monkeypatch):
    import builtins

    path = str(tmp_path / "c.jpg")
    imageio.imwrite(path, IMAGES["rgb8"])
    real_import = builtins.__import__

    def no_pil(name, *args, **kwargs):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("No module named 'PIL'")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    with pytest.raises(ImportError, match="Pillow"):
        frameio.read_image(path)
