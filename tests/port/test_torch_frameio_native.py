"""The port's frame loader API (``gradslam_torch/datasets/frameio.py``:
``decode_color``, ``decode_depth``, ``FrameLoader``) and its ``'native'``
dataset loader against the JAX package's, with ``libframeio`` built from
``native/frameio/frameio.cpp`` into the test's temporary directory (with
``native/build.sh``'s g++ line; the repo's ``native/`` is not written) and
loaded with ``ctypes`` into ``gradslam_tpu.datasets.frameio._LIB``.

Tolerances: bit for bit (``array_equal``) on PNG frames at every size,
colour and depth, normalized or not. JPEG: the port decodes through
Pillow, the library through libjpeg; both decode with the same defaults
here and the frames are equal too (the gap measured is 0)."""

import concurrent.futures
import ctypes
import multiprocessing
import os
import subprocess

import numpy as np
import pytest
import torch

imageio = pytest.importorskip("imageio.v2")
pytest.importorskip("jax")

from gradslam_torch.datasets import ICL as TorchICL  # noqa: E402
from gradslam_torch.datasets import TUM as TorchTUM  # noqa: E402
from gradslam_torch.datasets import Scannet as TorchScannet  # noqa: E402
from gradslam_torch.datasets import frameio  # noqa: E402
from gradslam_tpu.datasets import ICL as JaxICL  # noqa: E402
from gradslam_tpu.datasets import TUM as JaxTUM  # noqa: E402
from gradslam_tpu.datasets import Scannet as JaxScannet  # noqa: E402
from gradslam_tpu.datasets import frameio as jax_frameio  # noqa: E402

from . import _pngfiles  # noqa: E402

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
SIZES = [(480, 640), (240, 320), (120, 160), (300, 400)]


@pytest.fixture(scope="module")
def libframeio(tmp_path_factory):
    """``libframeio.so`` built as ``native/build.sh`` builds it, but into a
    temporary directory, with the argtypes the JAX package sets."""
    out = str(tmp_path_factory.mktemp("libframeio") / "libframeio.so")
    subprocess.run(["g++", "-O3", "-std=c++17", "-fPIC", "-shared", "-o", out,
                    os.path.join(ROOT, "native", "frameio", "frameio.cpp"),
                    "-lpng", "-ljpeg", "-lpthread"], check=True)
    lib = ctypes.CDLL(out)
    fp = ctypes.POINTER(ctypes.c_float)
    lib.frameio_loader_create.restype = ctypes.c_void_p
    lib.frameio_loader_create.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                          ctypes.c_int, ctypes.c_int]
    lib.frameio_loader_destroy.argtypes = [ctypes.c_void_p]
    lib.frameio_loader_submit.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p,
                                          ctypes.c_char_p]
    lib.frameio_loader_fetch.restype = ctypes.c_int
    lib.frameio_loader_fetch.argtypes = [ctypes.c_void_p, ctypes.c_int, fp, fp]
    lib.frameio_decode_color.restype = ctypes.c_int
    lib.frameio_decode_color.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                                         ctypes.c_int, fp]
    lib.frameio_decode_depth.restype = ctypes.c_int
    lib.frameio_decode_depth.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                                         ctypes.c_float, fp]
    assert not os.path.exists(os.path.join(ROOT, "native", "libframeio.so"))
    return lib


@pytest.fixture
def jax_native(libframeio, monkeypatch):
    """The JAX package's frameio with the built library loaded."""
    monkeypatch.setattr(jax_frameio, "_LIB", libframeio)
    assert jax_frameio.is_available()
    return jax_frameio


@pytest.fixture(scope="module")
def frames_480(tmp_path_factory):
    """480x640 frames: colour (RGB 8-bit, grey 8-bit, RGB 16-bit), depth
    16-bit and 8-bit, written with every row filter."""
    d = tmp_path_factory.mktemp("frames_480")
    rng = np.random.RandomState(11)
    files = {
        "rgb": (rng.rand(480, 640, 3) * 256).astype(np.uint8),
        "grey": (rng.rand(480, 640) * 256).astype(np.uint8),
        "rgb16": (rng.rand(480, 640, 3) * 65536).astype(np.uint16),
        "depth16": (rng.rand(480, 640) * 6000 + 500).astype(np.uint16),
        "depth8": (rng.rand(480, 640) * 256).astype(np.uint8),
    }
    paths = {}
    for name, img in files.items():
        paths[name] = str(d / f"{name}.png")
        frameio.write_png(paths[name], img, filters=(0, 1, 2, 3, 4))
    return paths


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("name", ["rgb", "grey", "rgb16"])
def test_decode_color_equals_libframeio(jax_native, frames_480, name, size, normalize):
    """Bit for bit: the bilinear colours left unrounded, ``* (1.0f / 255)``
    when normalizing, grey broadcast to three channels, and a 16-bit image
    read as the library reads it (its little-endian bytes)."""
    h, w = size
    got = frameio.decode_color(frames_480[name], h, w, normalize)
    want = jax_native.decode_color(frames_480[name], h, w, normalize)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape == (h, w, 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("scale", [5000.0, 1000.0, 3.3])
@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("name", ["depth16", "depth8"])
def test_decode_depth_equals_libframeio(jax_native, frames_480, name, size, scale):
    """Bit for bit: the nearest sample at ``(int)(y * sy)``, times ``1.0f /
    depth_scale`` (not divided by it), for 16-bit and 8-bit depth."""
    h, w = size
    got = frameio.decode_depth(frames_480[name], h, w, scale)
    want = jax_native.decode_depth(frames_480[name], h, w, scale)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape == (h, w)
    np.testing.assert_array_equal(got, want)


def test_depth_is_a_product_not_a_quotient(frames_480):
    """The repair's witness: at least one depth differs by an ulp from
    ``value / scale`` (what the port's ``'cv2'`` loader computes)."""
    got = frameio.decode_depth(frames_480["depth16"], 480, 640, 5000.0)
    raw = frameio.read_png(frames_480["depth16"]).astype(np.float32)
    assert np.array_equal(got, raw * (np.float32(1) / np.float32(5000.0)))
    assert not np.array_equal(got, raw / np.float32(5000.0))


@pytest.mark.parametrize("interlace", [False, True])
@pytest.mark.parametrize("name", ["gray1", "gray2", "gray4", "pal1", "pal4", "pal8", "rgb16",
                                  "graya8", "rgba16"])
def test_formats_decode_through_the_api_as_libpng_does(jax_native, tmp_path, name, interlace):
    """The codec's newer formats read through the API as the library reads
    them with libpng's expansions (palette to RGB, grey to 8 bits, alpha
    stripped), at the stored size and resized."""
    from .test_torch_frameio import FORMATS

    samples, color, depth, palette = FORMATS[name]
    path = _pngfiles.write(tmp_path / f"{name}.png", samples, color, depth,
                           interlace=interlace, palette=palette)
    h, w = samples.shape[:2]
    for size in ((h, w), (max(1, h // 2), max(1, w // 3)), (2 * h + 1, w + 3)):
        np.testing.assert_array_equal(frameio.decode_color(path, *size),
                                      jax_native.decode_color(path, *size))
        np.testing.assert_array_equal(frameio.decode_depth(path, *size, 1000.0),
                                      jax_native.decode_depth(path, *size, 1000.0))


def test_jpeg_gap_to_libjpeg(jax_native, tmp_path):
    """JPEG through Pillow against the library's libjpeg: the gap is 0 on
    this frame (both decode with the default islow IDCT and fancy
    upsampling)."""
    path = str(tmp_path / "c.jpg")
    imageio.imwrite(path, (np.random.RandomState(3).rand(96, 128, 3) * 256).astype(np.uint8))
    for size in ((96, 128), (48, 64), (60, 100)):
        gap = np.abs(frameio.decode_color(path, *size) - jax_native.decode_color(path, *size))
        assert gap.max() == 0.0


def test_decode_failures_return_none(jax_native, tmp_path):
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"\x89PNG\r\n\x1a\nnot really")
    for path in (str(bad), str(tmp_path / "missing.png")):
        assert frameio.decode_color(path, 4, 4) is None
        assert jax_native.decode_color(path, 4, 4) is None
        assert frameio.decode_depth(path, 4, 4, 1.0) is None
    assert frameio.is_available()


def test_frame_loader_equals_the_library_loader(jax_native, frames_480):
    """Out-of-order fetches equal the library's loader and the one-shot
    decoders; a failed frame raises ``IOError``; ``close`` twice is safe;
    the loader decodes on threads and starts no process."""
    colors = [frames_480["rgb"], frames_480["grey"], frames_480["rgb"], frames_480["rgb16"]]
    depths = [frames_480["depth16"], frames_480["depth8"], frames_480["depth16"],
              frames_480["depth16"]]
    ours = frameio.FrameLoader(240, 320, 5000.0, normalize_color=True, num_threads=3)
    theirs = jax_native.FrameLoader(240, 320, 5000.0, normalize_color=True, num_threads=3)
    assert isinstance(ours._pool, concurrent.futures.ThreadPoolExecutor)
    ours.submit_sequence(colors, depths)
    theirs.submit_sequence(colors, depths)
    ours.submit(9, frames_480["rgb"], frames_480["rgb"] + ".missing")
    for i in (3, 0, 2, 1):
        rgb, depth = ours.fetch(i)
        want = theirs.fetch(i)
        np.testing.assert_array_equal(rgb, want[0])
        np.testing.assert_array_equal(depth, want[1])
        np.testing.assert_array_equal(rgb, frameio.decode_color(colors[i], 240, 320, True))
        np.testing.assert_array_equal(depth, frameio.decode_depth(depths[i], 240, 320, 5000.0))
    with pytest.raises(IOError, match="failed to load frame 9"):
        ours.fetch(9)
    with pytest.raises(IOError, match="no frame 0"):
        ours.fetch(0)
    ours.close()
    ours.close()
    theirs.close()
    theirs.close()
    with pytest.raises(RuntimeError, match="closed"):
        ours.submit(0, colors[0], depths[0])
    assert multiprocessing.active_children() == []


def _write_tum(root, n, h, w, seed):
    seqdir = root / "rgbd_dataset_freiburg1_xyz"
    (seqdir / "rgb").mkdir(parents=True)
    (seqdir / "depth").mkdir()
    rng = np.random.RandomState(seed)
    rgb_lines, depth_lines, gt_lines = ["# rgb"], ["# depth"], ["# gt"]
    for i in range(n):
        t = 100.0 + 0.05 * i
        frameio.write_png(str(seqdir / "rgb" / f"{t:.6f}.png"),
                          (rng.rand(h, w, 3) * 256).astype(np.uint8), filters=(1, 4))
        frameio.write_png(str(seqdir / "depth" / f"{t:.6f}.png"),
                          (rng.rand(h, w) * 5000 + 1000).astype(np.uint16), filters=(2, 3))
        rgb_lines.append(f"{t:.6f} rgb/{t:.6f}.png")
        depth_lines.append(f"{t:.6f} depth/{t:.6f}.png")
        gt_lines.append(f"{t:.6f} {0.01 * i:.4f} 0 0.1 0 0 0 1")
    (seqdir / "rgb.txt").write_text("\n".join(rgb_lines))
    (seqdir / "depth.txt").write_text("\n".join(depth_lines))
    (seqdir / "groundtruth.txt").write_text("\n".join(gt_lines))
    (seqdir / "accelerometer.txt").write_text("#")
    return str(root)


def _write_icl(root, n, h, w, seed):
    traj = root / "living_room_traj1_frei_png"
    (traj / "rgb").mkdir(parents=True)
    (traj / "depth").mkdir()
    rng = np.random.RandomState(seed)
    assoc, gt = [], []
    for i in range(n):
        frameio.write_png(str(traj / "rgb" / f"{i}.png"),
                          (rng.rand(h, w, 3) * 256).astype(np.uint8))
        frameio.write_png(str(traj / "depth" / f"{i}.png"),
                          (rng.rand(h, w) * 5000 + 1000).astype(np.uint16))
        assoc.append(f"{i} depth/{i}.png {i} rgb/{i}.png")
        gt.append(f"{i} {0.02 * i:.4f} 0 0 0 0 0 1")
    (traj / "associations.txt").write_text("\n".join(assoc))
    (traj / "livingRoom1.gt.freiburg").write_text("\n".join(gt))
    return str(root)


def _assert_native_equal(js, ts):
    """A JAX sample against the port's: every element bit for bit."""
    assert len(js) == len(ts)
    for j, t in zip(js, ts):
        if isinstance(j, str):
            assert t == j
            continue
        t = t.numpy()
        assert t.dtype == np.asarray(j).dtype and t.shape == np.asarray(j).shape
        np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("size", [(480, 640), (240, 320)])
def test_tum_native_equals_jax_native(jax_native, tmp_path, size, normalize):
    """The repair: the port's ``loader='native'`` reads 480x640 PNG frames
    as the JAX package's does through ``libframeio``, bit for bit, at the
    stored size and at 240x320 (where the colours are left unrounded and
    depth is a product)."""
    root = _write_tum(tmp_path, 3, 480, 640, seed=1)
    kw = dict(seqlen=3, height=size[0], width=size[1], normalize_color=normalize,
              loader="native")
    jd, td = JaxTUM(root, **kw), TorchTUM(root, **kw)
    assert len(jd) == len(td) == 1
    _assert_native_equal(jd[0], td[0])
    if size != (480, 640):
        cv2_path = TorchTUM(root, **dict(kw, loader="cv2"))[0]
        assert not torch.equal(cv2_path[0], td[0][0])


@pytest.mark.parametrize("size", [(480, 640), (240, 320)])
def test_icl_native_equals_jax_native(jax_native, tmp_path, size):
    root = _write_icl(tmp_path, 2, 480, 640, seed=2)
    kw = dict(seqlen=2, height=size[0], width=size[1], loader="native")
    jd, td = JaxICL(root, **kw), TorchICL(root, **kw)
    assert len(jd) == len(td) == 1
    _assert_native_equal(jd[0], td[0])


def test_scannet_native_equals_jax_native(jax_native, tmp_path):
    """ScanNet's branch: JPEG colour (Pillow against libjpeg, equal here),
    16-bit depth / 1000, labels through the codec, at 240x320."""
    scene = tmp_path / "scans" / "scene0000_00"
    for sub in ("color", "depth", "pose", "label-filt", "intrinsic"):
        (scene / sub).mkdir(parents=True)
    (tmp_path / "seqmeta").mkdir()
    np.savetxt(str(scene / "intrinsic" / "intrinsic_depth.txt"),
               np.diag([400.0, 410.0, 1.0, 1.0]))
    rng = np.random.RandomState(4)
    lines = []
    for i in range(2):
        imageio.imwrite(str(scene / "color" / f"{i}.jpg"),
                        (rng.rand(480, 640, 3) * 255).astype(np.uint8))
        frameio.write_png(str(scene / "depth" / f"{i}.png"),
                          (rng.rand(480, 640) * 3000 + 500).astype(np.uint16))
        frameio.write_png(str(scene / "label-filt" / f"{i}.png"),
                          rng.randint(0, 41, (480, 640)).astype(np.uint8))
        np.savetxt(str(scene / "pose" / f"{i}.txt"), np.eye(4))
        lines.append(
            f"color scene0000_00/color/{i}.jpg depth scene0000_00/depth/{i}.png "
            f"pose scene0000_00/pose/{i}.txt label-filt scene0000_00/label-filt/{i}.png "
            "intrinsic_color x extrinsic_color y extrinsic_depth z "
            "intrinsic_depth scene0000_00/intrinsic/intrinsic_depth.txt")
    (tmp_path / "seqmeta" / "scene0000_00-seq_0.txt").write_text("\n".join(lines))
    kw = dict(height=240, width=320, loader="native")
    jd = JaxScannet(str(tmp_path / "scans"), str(tmp_path / "seqmeta"), None, **kw)
    td = TorchScannet(str(tmp_path / "scans"), str(tmp_path / "seqmeta"), None, **kw)
    _assert_native_equal(jd[0], td[0])


def test_native_falls_back_to_cv2_on_a_bad_frame(tmp_path):
    """As in the JAX package: a frame that fails to decode warns and the
    sample is read by the ``'cv2'`` path (which then raises on it)."""
    root = _write_tum(tmp_path, 2, 24, 32, seed=3)
    td = TorchTUM(root, seqlen=2, height=24, width=32, loader="native")
    bad = td.samples[0]["color_paths"][1]
    with open(bad, "r+b") as f:
        f.truncate(60)
    with pytest.warns(UserWarning, match="falling back to the cv2 path"):
        with pytest.raises(ValueError):
            td[0]
