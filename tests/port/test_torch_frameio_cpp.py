"""The frame decoder's C++ library (``gradslam_torch/datasets/csrc/frameio.cpp``,
built with the host's ``g++`` at first use) against its plain version,
the numpy codec and arithmetic of ``gradslam_torch/datasets/frameio.py``.

Tolerances: none. Every decode is bit for bit (``array_equal`` with equal
dtype and shape): every colour type and bit depth pair PNG defines, plain
and Adam7, each row filter alone and a mixed cycle, at 1x1, 1xN, Nx1, odd
widths and sub-byte row tails; the refusals raise the plain codec's error
word for word; ``decode_color``/``decode_depth`` equal the numpy float32
arithmetic (``_color_arithmetic``, ``_depth_arithmetic``) on the plain
decode. ``FrameLoader`` runs threads and no process; a missing compiler
raises, and nothing falls back to the numpy decoder."""

import multiprocessing
import os
import struct
import zlib

import numpy as np
import pytest

from gradslam_torch.datasets import TUM as TorchTUM
from gradslam_torch.datasets import frameio
from gradslam_torch.ops import _build

from . import _pngfiles

# (colour type, bit depth): every pair PNG defines
FORMATS = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16), (3, 1), (3, 2), (3, 4),
           (3, 8), (4, 8), (4, 16), (6, 8), (6, 16)]
FILE_SAMPLES = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
FILTERS = {"none": (0,), "sub": (1,), "up": (2,), "average": (3,), "paeth": (4,),
           "mixed": (4, 1, 2, 3, 0)}
# 1x1, 1xN, Nx1, odd widths; at 1, 2 and 4 bits most widths leave a
# partial last byte (a sub-byte row tail)
SIZES = [(1, 1), (1, 13), (13, 1), (7, 5), (9, 11), (6, 17), (10, 3), (17, 9)]


def _samples(rng, color, depth, size):
    """Random samples ``(H, W, C)`` of a format, and a palette for colour
    type 3 with fewer entries than the indices reach (those read black)."""
    h, w = size
    values = rng.randint(0, 1 << depth, (h, w, FILE_SAMPLES[color]))
    palette = None
    if color == 3:
        palette = rng.randint(0, 256, (max(1, (1 << depth) - 3), 3))
    return values, palette


def _assert_same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("filters", sorted(FILTERS))
@pytest.mark.parametrize("interlace", [0, 1])
@pytest.mark.parametrize("color,depth", FORMATS)
def test_library_decode_equals_the_plain_codec(color, depth, interlace, filters):
    rng = np.random.RandomState(100 * color + depth)
    for size in SIZES:
        values, palette = _samples(rng, color, depth, size)
        data = _pngfiles.png_bytes(values, color, depth, interlace=bool(interlace),
                                   palette=palette, filters=FILTERS[filters])
        got, want = frameio.decode_png(data), frameio.decode_png_plain(data)
        _assert_same(got, want)
        if color == 3:  # palette entries looked up, indices past PLTE black
            table = np.zeros((256, 3), np.uint8)
            table[:len(palette)] = palette
            np.testing.assert_array_equal(got, table[values[..., 0]])


def _png_of_rows(rows: bytes, width, height, depth, color, interlace=0, palette=None) -> bytes:
    """A PNG whose IDAT inflates to ``rows`` as given."""
    out = frameio.PNG_SIGNATURE + frameio._chunk(
        b"IHDR", struct.pack(">IIBBBBB", width, height, depth, color, 0, 0, interlace))
    if palette is not None:
        out += frameio._chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    return out + frameio._chunk(b"IDAT", zlib.compress(rows)) + frameio._chunk(b"IEND", b"")


def _refused(kind: str, interlace: int) -> bytes:
    """A 12x10 RGB file (plain or Adam7) with a bad filter byte, or with its
    image data one byte short or long."""
    values = np.random.RandomState(7).randint(0, 256, (10, 12, 3))
    data = _pngfiles.png_bytes(values, 2, 8, interlace=bool(interlace), filters=(4, 1, 2, 3, 0))
    rows = bytearray(frameio._read_chunks(data)[2])
    if kind == "bad_filter":
        rows[0] = 7 if interlace else 5
        if not interlace:
            rows[2 * (12 * 3 + 1)] = 9  # row 2: the pass's largest type is reported
    elif kind == "short":
        rows = rows[:-1]
    else:
        rows += b"\0"
    return _png_of_rows(bytes(rows), 12, 10, 8, 2, interlace)


@pytest.mark.parametrize("interlace", [0, 1])
@pytest.mark.parametrize("kind", ["bad_filter", "short", "long"])
def test_refusals_raise_as_the_plain_codec_does(tmp_path, kind, interlace):
    data = _refused(kind, interlace)
    with pytest.raises(ValueError) as plain:
        frameio.decode_png_plain(data)
    with pytest.raises(ValueError) as lib:
        frameio.decode_png(data)
    assert str(lib.value) == str(plain.value)
    assert ("filter type" in str(lib.value)) == (kind == "bad_filter")
    # at the loader API: None, and IOError from FrameLoader
    path = str(tmp_path / "bad.png")
    with open(path, "wb") as f:
        f.write(data)
    good = str(tmp_path / "good.png")
    frameio.write_png(good, np.zeros((10, 12), np.uint16))
    assert frameio.decode_color(path, 10, 12) is None
    assert frameio.decode_depth(path, 10, 12, 1000.0) is None
    loader = frameio.FrameLoader(10, 12, 1000.0, num_threads=2)
    loader.submit(0, path, good)
    loader.submit(1, good, path)
    for i in (1, 0):
        with pytest.raises(IOError, match=f"failed to load frame {i}"):
            loader.fetch(i)
    loader.close()


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    """480x640 files, rows cycling every filter: RGB, grey and 16-bit RGB
    colour, a palette file, 16-bit and 8-bit depth; with each its plain
    decode."""
    d = tmp_path_factory.mktemp("frames")
    rng = np.random.RandomState(12)
    paths = {}
    for name, img in (("rgb", (rng.rand(480, 640, 3) * 256).astype(np.uint8)),
                      ("grey", (rng.rand(480, 640) * 256).astype(np.uint8)),
                      ("rgb16", (rng.rand(480, 640, 3) * 65536).astype(np.uint16)),
                      ("depth16", (rng.rand(480, 640) * 6000 + 500).astype(np.uint16)),
                      ("depth8", (rng.rand(480, 640) * 256).astype(np.uint8))):
        paths[name] = str(d / f"{name}.png")
        frameio.write_png(paths[name], img, filters=(4, 1, 2, 3, 0))
    paths["palette"] = _pngfiles.write(d / "palette.png", rng.randint(0, 256, (480, 640)), 3, 8,
                                       palette=rng.randint(0, 256, (240, 3)))
    plain = {}
    for name, path in paths.items():
        with open(path, "rb") as f:
            plain[name] = frameio.decode_png_plain(f.read())
    return paths, plain


RESIZES = [(480, 640), (240, 320), (517, 701), (33, 47)]  # stored, halved, up, down


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("size", RESIZES)
@pytest.mark.parametrize("name", ["rgb", "grey", "rgb16", "palette"])
def test_decode_color_equals_the_numpy_arithmetic(frames, name, size, normalize):
    paths, plain = frames
    got = frameio.decode_color(paths[name], *size, normalize)
    _assert_same(got, frameio._color_arithmetic(plain[name], *size, normalize))


@pytest.mark.parametrize("scale", [5000.0, 1000.0, 3.3])
@pytest.mark.parametrize("size", RESIZES)
@pytest.mark.parametrize("name", ["depth16", "depth8", "rgb16"])
def test_decode_depth_equals_the_numpy_arithmetic(frames, name, size, scale):
    paths, plain = frames
    got = frameio.decode_depth(paths[name], *size, scale)
    _assert_same(got, frameio._depth_arithmetic(plain[name], *size, scale))


def test_jpeg_samples_resize_through_the_library(tmp_path):
    """JPEG is decoded by Pillow and resized by the library: equal to the
    numpy arithmetic on Pillow's samples."""
    image_mod = pytest.importorskip("PIL.Image")
    path = str(tmp_path / "c.jpg")
    image_mod.fromarray((np.random.RandomState(3).rand(96, 128, 3) * 256)
                        .astype(np.uint8)).save(path)
    samples = frameio.read_image(path)
    for size in ((96, 128), (48, 64), (60, 100), (200, 250)):
        for normalize in (False, True):
            _assert_same(frameio.decode_color(path, *size, normalize),
                         frameio._color_arithmetic(samples, *size, normalize))
        _assert_same(frameio.decode_depth(path, *size, 1000.0),
                     frameio._depth_arithmetic(samples, *size, 1000.0))


@pytest.fixture(scope="module")
def sequence(tmp_path_factory):
    """Twelve 60x80 colour and depth files."""
    d = tmp_path_factory.mktemp("sequence")
    rng = np.random.RandomState(4)
    colors, depths = [], []
    for i in range(12):
        colors.append(str(d / f"c{i}.png"))
        depths.append(str(d / f"d{i}.png"))
        frameio.write_png(colors[-1], (rng.rand(60, 80, 3) * 256).astype(np.uint8),
                          filters=(i % 5, 4))
        frameio.write_png(depths[-1], (rng.rand(60, 80) * 5000 + 100).astype(np.uint16),
                          filters=(3, i % 5))
    return colors, depths


@pytest.mark.parametrize("threads", [1, 8])
def test_frame_loader_on_threads(sequence, tmp_path, threads):
    """Out-of-order fetches equal the one-shot decoders, a frame fetched
    twice or never queued raises ``IOError``, a bad file raises ``IOError``,
    ``close`` twice is safe, a submit after it raises ``RuntimeError``, and
    no process is started."""
    colors, depths = sequence
    before = multiprocessing.active_children()
    loader = frameio.FrameLoader(30, 40, 5000.0, normalize_color=True, num_threads=threads)
    loader.submit_sequence(colors, depths)
    bad = tmp_path / "bad.png"
    bad.write_bytes(frameio.PNG_SIGNATURE + b"not really")
    loader.submit(20, colors[0], str(bad))
    loader.submit(21, str(tmp_path / "missing.png"), depths[0])
    for i in (11, 0, 5, 3, 1, 2, 4, 6, 10, 9, 8, 7):
        rgb, depth = loader.fetch(i)
        _assert_same(rgb, frameio.decode_color(colors[i], 30, 40, True))
        _assert_same(depth, frameio.decode_depth(depths[i], 30, 40, 5000.0))
    for i in (20, 21):
        with pytest.raises(IOError, match=f"failed to load frame {i}"):
            loader.fetch(i)
    with pytest.raises(IOError, match="no frame 5"):
        loader.fetch(5)
    assert multiprocessing.active_children() == before == []
    loader.close()
    loader.close()
    with pytest.raises(RuntimeError, match="closed"):
        loader.submit(0, colors[0], depths[0])


def test_one_and_eight_threads_give_the_same_bytes(sequence):
    colors, depths = sequence
    runs = []
    for threads in (1, 8):
        loader = frameio.FrameLoader(45, 70, 1000.0, num_threads=threads)
        loader.submit_sequence(colors, depths)
        runs.append([loader.fetch(i) for i in range(len(colors))])
        loader.close()
    for (a_rgb, a_depth), (b_rgb, b_depth) in zip(*runs):
        assert a_rgb.tobytes() == b_rgb.tobytes() and a_depth.tobytes() == b_depth.tobytes()


def test_native_sample_is_the_library_loaders(tmp_path):
    """``TUM(loader='native')`` equals ``FrameLoader`` frame by frame and
    starts no process."""
    from .test_torch_frameio_native import _write_tum

    root = _write_tum(tmp_path, 3, 48, 64, seed=8)
    ds = TorchTUM(root, seqlen=3, height=24, width=32, loader="native")
    sample = ds[0]
    loader = frameio.FrameLoader(24, 32, 5000.0)
    loader.submit_sequence(ds.samples[0]["color_paths"], ds.samples[0]["depth_paths"])
    for i in range(3):
        rgb, depth = loader.fetch(i)
        np.testing.assert_array_equal(sample[0][i].numpy(), rgb)
        np.testing.assert_array_equal(sample[1][i, ..., 0].numpy(), depth)
    loader.close()
    assert multiprocessing.active_children() == []


@pytest.fixture
def fresh_build(tmp_path, monkeypatch):
    """An empty build directory, so the next load must compile; the loaded
    library is forgotten before and after."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    frameio.load_library.cache_clear()
    yield tmp_path / "build"
    frameio.load_library.cache_clear()


@pytest.mark.parametrize("how", ["cxx_missing", "empty_path"])
def test_missing_compiler_raises_and_nothing_falls_back(fresh_build, tmp_path, monkeypatch, how):
    png = str(tmp_path / "f.png")
    frameio.write_png(png, np.zeros((4, 4, 3), np.uint8))
    if how == "cxx_missing":
        monkeypatch.setenv("CXX", str(tmp_path / "no" / "such-g++"))
    else:
        monkeypatch.delenv("CXX", raising=False)
        monkeypatch.setenv("PATH", "")
    with pytest.raises(RuntimeError, match="compiler .* not found"):
        frameio.load_library()
    assert not frameio.is_available()
    for call in (lambda: frameio.read_png(png), lambda: frameio.decode_color(png, 4, 4),
                 lambda: frameio.decode_depth(png, 4, 4, 1.0),
                 lambda: frameio.FrameLoader(4, 4, 1.0)):
        with pytest.raises(RuntimeError, match="not found"):
            call()
    from .test_torch_frameio_native import _write_tum

    monkeypatch.undo()  # write the tree with the real library, then take the compiler away
    frameio.load_library.cache_clear()
    root = _write_tum(tmp_path / "tum", 2, 12, 16, seed=9)
    monkeypatch.setattr(_build, "BUILD_DIR", fresh_build)
    monkeypatch.setenv("CXX", str(tmp_path / "no" / "such-g++"))
    frameio.load_library.cache_clear()
    for loader in ("native", "cv2"):
        with pytest.raises(RuntimeError, match="not found"):
            TorchTUM(root, seqlen=2, height=12, width=16, loader=loader)[0]
    assert not fresh_build.exists() or not any(fresh_build.glob("*.so"))


def test_failed_build_raises_with_the_compilers_output(fresh_build, tmp_path, monkeypatch):
    cxx = tmp_path / "broken-g++"
    cxx.write_text("#!/bin/sh\necho 'frameio.cpp:1: error: the compiler said no' >&2\nexit 3\n")
    cxx.chmod(0o755)
    monkeypatch.setenv("CXX", str(cxx))
    with pytest.raises(RuntimeError, match="the compiler said no") as err:
        frameio.load_library()
    assert "failed (3)" in str(err.value)
    assert not any(fresh_build.glob("*.so"))


def test_build_lands_by_rename_under_a_hash_of_sources_and_flags(fresh_build, tmp_path):
    path = frameio.load_library()._name
    assert os.path.dirname(path) == str(fresh_build)
    assert os.path.basename(path).startswith("libgradslam_frameio_")
    assert os.listdir(fresh_build) == [os.path.basename(path)]  # no temporary left
    src = tmp_path / "x.cpp"
    src.write_text("// a")
    first = _build._digest([src], _build.HOST_FLAGS)
    assert _build._digest([src], _build.HOST_FLAGS + ["-g"]) != first
    src.write_text("// b")
    assert _build._digest([src], _build.HOST_FLAGS) != first
    assert "-ffp-contract=off" in _build.HOST_FLAGS
    assert not any(f.startswith("-march") or "fast-math" in f for f in _build.HOST_FLAGS)
