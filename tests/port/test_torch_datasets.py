"""The port's TUM, ICL and ScanNet loaders and their helpers against the JAX
package's, on fake on-disk trees built as the JAX package's dataset tests
build them (imageio writing PNG and JPEG frames).

Tolerances: everything is exact (same dtype, bit-equal values) except the
colour of a frame resized by a ratio other than 1 or 2, where the port's
float bilinear may differ from cv2's 11-bit fixed-point one by one level
(at most 1.0 on the 0-255 scale). Depth and labels are resized by nearest
neighbour and equal exactly at every size; at an exact 2x reduction cv2
averages 2x2 blocks and the colours are exact too.
"""

import numpy as np
import pytest

imageio = pytest.importorskip("imageio.v2")
pytest.importorskip("jax")

from gradslam_torch.datasets import ICL as TorchICL  # noqa: E402
from gradslam_torch.datasets import TUM as TorchTUM  # noqa: E402
from gradslam_torch.datasets import Scannet as TorchScannet  # noqa: E402
from gradslam_torch.datasets import base as torch_base  # noqa: E402
from gradslam_torch.datasets import datautils as torch_datautils  # noqa: E402
from gradslam_torch.datasets import icl as torch_icl  # noqa: E402
from gradslam_torch.datasets import scannet as torch_scannet  # noqa: E402
from gradslam_torch.datasets import tumutils as torch_tumutils  # noqa: E402
from gradslam_tpu.datasets import ICL as JaxICL  # noqa: E402
from gradslam_tpu.datasets import TUM as JaxTUM  # noqa: E402
from gradslam_tpu.datasets import Scannet as JaxScannet  # noqa: E402
from gradslam_tpu.datasets import base as jax_base  # noqa: E402
from gradslam_tpu.datasets import datautils as jax_datautils  # noqa: E402
from gradslam_tpu.datasets import icl as jax_icl  # noqa: E402
from gradslam_tpu.datasets import scannet as jax_scannet  # noqa: E402
from gradslam_tpu.datasets import tumutils as jax_tumutils  # noqa: E402

import torch  # noqa: E402

N_LONG = 40


def _frames(rng, n, h, w):
    rgb = (rng.rand(n, h, w, 3) * 255).astype(np.uint8)
    depth = (rng.rand(n, h, w) * 5000 + 1000).astype(np.uint16)
    return rgb, depth


@pytest.fixture(scope="module")
def tum_tree(tmp_path_factory):
    """``tests/datasets/test_long_sequence.py``'s 40-frame tree: depth stamps
    jittered inside the 0.02 s gate and every 10th depth frame missing."""
    root = tmp_path_factory.mktemp("tum_long")
    seqdir = root / "rgbd_dataset_freiburg1_long"
    (seqdir / "rgb").mkdir(parents=True)
    (seqdir / "depth").mkdir()
    rng = np.random.RandomState(7)
    rgb, depth = _frames(rng, N_LONG, 48, 64)
    rgb_lines, depth_lines, gt_lines = ["# rgb"], ["# depth"], ["# gt"]
    for i in range(N_LONG):
        t = 1000.0 + i * 0.05
        imageio.imwrite(str(seqdir / "rgb" / f"{t:.6f}.png"), rgb[i])
        rgb_lines.append(f"{t:.6f} rgb/{t:.6f}.png")
        if i % 10:
            td = t + 0.001 + 0.014 * rng.rand()
            imageio.imwrite(str(seqdir / "depth" / f"{td:.6f}.png"), depth[i])
            depth_lines.append(f"{td:.6f} depth/{td:.6f}.png")
        q = rng.randn(4)  # a rotating camera, quaternions not normalized
        gt_lines.append(f"{t + 0.002:.6f} {0.01 * i:.4f} {0.003 * i:.4f} 0.1 "
                        + " ".join(f"{v:.6f}" for v in q))
    (seqdir / "rgb.txt").write_text("\n".join(rgb_lines))
    (seqdir / "depth.txt").write_text("\n".join(depth_lines))
    (seqdir / "groundtruth.txt").write_text("\n".join(gt_lines))
    (seqdir / "accelerometer.txt").write_text("#")
    return str(root)


@pytest.fixture(scope="module")
def icl_tree(tmp_path_factory):
    """Two trajectories: 12 frames with ``.gt.freiburg`` poses, and 7 frames
    with ``.gt.sim`` poses one short (the last frame is dropped)."""
    root = tmp_path_factory.mktemp("icl")
    rng = np.random.RandomState(8)
    for name, n, fmt in (("living_room_traj1_frei_png", 12, "freiburg"),
                         ("living_room_traj0_frei_png", 7, "sim")):
        traj = root / name
        (traj / "rgb").mkdir(parents=True)
        (traj / "depth").mkdir()
        rgb, depth = _frames(rng, n, 48, 64)
        assoc, gt = [], []
        for i in range(n):
            imageio.imwrite(str(traj / "rgb" / f"{i}.png"), rgb[i])
            imageio.imwrite(str(traj / "depth" / f"{i}.png"), depth[i])
            assoc.append(f"{i} depth/{i}.png {i} rgb/{i}.png")
            if fmt == "freiburg":
                gt.append(f"{i} {0.02 * i:.4f} {0.005 * i:.4f} 0 0 0 {0.01 * i:.4f} 1")
            elif i < n - 1:
                gt += [f"1 0 0 {0.1 * i:.3f}", "0 1 0 0.000", f"0 0 1 {0.01 * i:.3f}", ""]
        (traj / "associations.txt").write_text("\n".join(assoc))
        (traj / ("livingRoom1.gt.freiburg" if fmt == "freiburg" else "livingRoom0.gt.sim")
         ).write_text("\n".join(gt))
    return str(root)


@pytest.fixture(scope="module")
def scannet_tree(tmp_path_factory):
    """``tests/datasets/test_scannet_fake.py``'s scene: JPEG colour, 16-bit
    depth, 8-bit nyu40 labels, a pose file a frame; two sequences."""
    root = tmp_path_factory.mktemp("scannet")
    scans, meta = root / "scans", root / "seqmeta"
    meta.mkdir()
    rng = np.random.RandomState(0)
    for scene in ("scene0000_00", "scene0002_01"):
        d = scans / scene
        for sub in ("color", "depth", "pose", "label-filt", "intrinsic"):
            (d / sub).mkdir(parents=True)
        np.savetxt(str(d / "intrinsic" / "intrinsic_depth.txt"),
                   np.diag([400.0, 410.0, 1.0, 1.0]))
        lines = []
        for i in range(5):
            imageio.imwrite(str(d / "color" / f"{i}.jpg"),
                            (rng.rand(48, 64, 3) * 255).astype(np.uint8))
            imageio.imwrite(str(d / "depth" / f"{i}.png"),
                            (rng.rand(48, 64) * 3000 + 500).astype(np.uint16))
            imageio.imwrite(str(d / "label-filt" / f"{i}.png"),
                            rng.randint(0, 41, (48, 64)).astype(np.uint8))
            pose = np.eye(4)
            pose[:3, 3] = [0.05 * i, 0.01 * i, 0.0]
            np.savetxt(str(d / "pose" / f"{i}.txt"), pose)
            lines.append(
                f"color {scene}/color/{i}.jpg depth {scene}/depth/{i}.png "
                f"pose {scene}/pose/{i}.txt label-filt {scene}/label-filt/{i}.png "
                f"intrinsic_color x extrinsic_color y extrinsic_depth z "
                f"intrinsic_depth {scene}/intrinsic/intrinsic_depth.txt")
        (meta / f"{scene}-seq_0.txt").write_text("\n".join(lines))
    return str(scans), str(meta)


def _resized_exactly(h, w, src=(48, 64)):
    return (h, w) in (src, (src[0] // 2, src[1] // 2))


def assert_samples_equal(js, ts, color_exact: bool):
    """A JAX sample (numpy arrays, a name) against the port's (CPU tensors,
    the same name): element by element, dtype and values; colours (element
    0) within one level unless ``color_exact``."""
    assert len(js) == len(ts)
    for k, (j, t) in enumerate(zip(js, ts)):
        if isinstance(j, str):
            assert t == j
            continue
        assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
        t = t.numpy()
        j = np.asarray(j)
        assert t.dtype == j.dtype and t.shape == j.shape, (k, t.dtype, j.dtype, t.shape, j.shape)
        if k == 0 and not color_exact:
            assert np.abs(t.astype(np.float64) - j).max() <= 1.0
        else:
            np.testing.assert_array_equal(t, j)


SIZES = [(48, 64), (24, 32), (36, 50), (96, 128), (30, 64)]


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("size", SIZES)
def test_tum_samples_equal_jax(tum_tree, size, normalize):
    """Every chunk of the 40-frame tree, seqlen 6 (36 associated frames):
    colours, depths, scaled intrinsics, re-based poses, transforms, names
    and timestamps. Normalized colours within 1/255."""
    h, w = size
    jd = JaxTUM(tum_tree, seqlen=6, height=h, width=w, normalize_color=normalize)
    td = TorchTUM(tum_tree, seqlen=6, height=h, width=w, normalize_color=normalize)
    assert len(td) == len(jd) == 6
    exact = _resized_exactly(h, w)
    for i in range(len(jd)):
        js, ts = jd[i], td[i]
        if normalize and not exact:
            assert np.abs(ts[0].numpy() - js[0]).max() <= 1.0 / 255.0 + 1e-7
            js, ts = js[1:], ts[1:]
        assert_samples_equal(js, ts, exact)


@pytest.mark.parametrize("kw", [
    dict(seqlen=4, dilation=1, stride=3),
    dict(seqlen=5, start=3, end=31),
    dict(seqlen=7, dilation=2),
    dict(seqlen=36),
    dict(seqlen=2, stride=1, end=9),
])
def test_tum_chunk_arithmetic_equals_jax(tum_tree, kw):
    """The chunking at 40 frames with dropped depth: the same number of
    samples, and each the same frames (depth exact), poses re-based to its
    own frame 0, names and timestamps."""
    jd = JaxTUM(tum_tree, height=24, width=32, **kw)
    td = TorchTUM(tum_tree, height=24, width=32, **kw)
    assert len(td) == len(jd) > 0
    for i in range(len(jd)):
        assert_samples_equal(jd[i], td[i], color_exact=True)


def test_tum_options_equal_jax(tum_tree):
    """channels_first, return_* switches and the 'native' loader, which
    gives the JAX native library's arithmetic (held bit for bit against it
    in test_torch_frameio_native.py): its colours within one level of the
    default loader's and its depths within one float32 ulp, every other
    output equal."""
    for kw in (dict(channels_first=True), dict(return_depth=False, return_timestamps=False),
               dict(return_pose=False, return_transform=True, return_names=False),
               dict(return_intrinsics=False, return_transform=False)):
        jd = JaxTUM(tum_tree, seqlen=3, height=24, width=32, **kw)
        td = TorchTUM(tum_tree, seqlen=3, height=24, width=32, **kw)
        assert_samples_equal(jd[2], td[2], color_exact=True)
    plain = TorchTUM(tum_tree, seqlen=5, height=36, width=50)
    native = TorchTUM(tum_tree, seqlen=5, height=36, width=50, loader="native")
    for k, (a, b) in enumerate(zip(plain[1], native[1])):
        if k == 0:
            assert (a - b).abs().max() <= 1.0
        elif k == 1:
            assert torch.allclose(a, b, rtol=2 ** -23, atol=0)
        else:
            assert a == b if isinstance(a, str) else torch.equal(a, b)
    with pytest.raises(ValueError):
        TorchTUM(tum_tree, loader="pil")
    with pytest.raises(ValueError):
        TorchTUM("/nonexistent/path")


def test_pin_memory_pins_every_tensor_of_a_sample(tum_tree, monkeypatch):
    """``pin_memory=True`` pins each tensor it returns (pinning needs a
    CUDA build of torch, so the call is watched on the CPU); the default
    pins none."""
    pinned = []
    monkeypatch.setattr(torch.Tensor, "pin_memory", lambda t: pinned.append(t.shape) or t)
    sample = TorchTUM(tum_tree, seqlen=2, height=24, width=32, pin_memory=True)[0]
    tensors = [t for t in sample if isinstance(t, torch.Tensor)]
    assert len(tensors) == 6 and pinned == [t.shape for t in tensors]
    pinned.clear()
    TorchTUM(tum_tree, seqlen=2, height=24, width=32)[0]
    assert pinned == []


@pytest.mark.parametrize("size", [(48, 64), (24, 32), (40, 56)])
def test_icl_samples_equal_jax(icl_tree, size):
    """Both trajectories (freiburg and sim poses, the short sim file
    dropping the last frame), ICL's negative fy scaled with the rest."""
    h, w = size
    jd = JaxICL(icl_tree, seqlen=3, height=h, width=w)
    td = TorchICL(icl_tree, seqlen=3, height=h, width=w)
    assert len(td) == len(jd) == 4 + 2
    for i in range(len(jd)):
        assert_samples_equal(jd[i], td[i], _resized_exactly(h, w))
    K = td[0][2]
    assert float(K[1, 1]) == pytest.approx(-480.0 * h / 480.0) and float(K[1, 1]) < 0
    jd = JaxICL(icl_tree, trajectories="living_room_traj1_frei_png", seqlen=5, dilation=1)
    td = TorchICL(icl_tree, trajectories="living_room_traj1_frei_png", seqlen=5, dilation=1)
    assert len(td) == len(jd) == 1
    assert_samples_equal(jd[0], td[0], color_exact=False)  # 48x64 -> 480x640


def test_icl_pose_readers_equal_jax(tmp_path):
    """``load_sim_poses`` and ``load_freiburg_poses`` against the JAX
    package's readers, exactly (``tests/datasets/test_icl_sim.py``'s
    file, plus rotations)."""
    f = tmp_path / "livingRoom0.gt.sim"
    lines = []
    for i in range(3):
        lines += [f"0.6 -0.8 0 {0.1 * i:.3f}", "0.8 0.6 0 0.000", "0 0 1 0.250", ""]
    f.write_text("\n".join(lines))
    got = torch_icl.load_sim_poses(str(f))
    np.testing.assert_array_equal(got, jax_icl._load_sim_poses(str(f)))
    assert got.shape == (3, 4, 4) and got.dtype == np.float32
    g = tmp_path / "x.gt.freiburg"
    g.write_text("# t x y z qx qy qz qw\n0 1 2 3 0.1 0.2 0.3 0.9\n1 0 0 0 0 0 0 1\n")
    np.testing.assert_array_equal(torch_icl.load_freiburg_poses(str(g)),
                                  jax_icl._load_freiburg_poses(str(g)))


@pytest.mark.parametrize("seg_classes", ["scannet20", "nyu40"])
@pytest.mark.parametrize("size", [(48, 64), (24, 32), (30, 40)])
def test_scannet_samples_equal_jax(scannet_tree, size, seg_classes):
    """JPEG colours (Pillow, as imageio reads them), depth / 1000, the
    per-scene intrinsics scaled, re-based poses, transforms, names and the
    nearest-resized, remapped labels."""
    scans, meta = scannet_tree
    h, w = size
    kw = dict(height=h, width=w, seg_classes=seg_classes, start=1, end=5)
    jd = JaxScannet(scans, meta, None, **kw)
    td = TorchScannet(scans, meta, None, **kw)
    assert len(td) == len(jd) == 2
    for i in range(2):
        assert_samples_equal(jd[i], td[i], _resized_exactly(h, w))
    assert list(td.color_encoding) == list(jd.color_encoding)
    jd = JaxScannet(scans, meta, ("scene0002_01",), height=h, width=w, return_labels=False)
    td = TorchScannet(scans, meta, ("scene0002_01",), height=h, width=w, return_labels=False)
    assert len(td) == len(jd) == 1
    assert_samples_equal(jd[0], td[0], _resized_exactly(h, w))


def test_scannet_helpers_equal_jax():
    labels = np.random.RandomState(3).randint(-3, 45, (6, 7))
    np.testing.assert_array_equal(torch_scannet.nyu40_to_scannet20(labels),
                                  jax_scannet.nyu40_to_scannet20(labels))
    for kind in ("nyu40", "scannet20", "ScanNet20"):
        assert torch_scannet.get_color_encoding(kind) == jax_scannet.get_color_encoding(kind)
    with pytest.raises(ValueError):
        torch_scannet.get_color_encoding("coco")
    names = ["scene10_00-seq_2.txt", "scene2_00-seq_10.txt", "scene2_00-seq_9.txt"]
    assert sorted(names, key=torch_scannet._natsort_key) == sorted(
        names, key=jax_scannet._natsort_key)


@pytest.mark.parametrize("src,dst", [((48, 64), (24, 32)), ((48, 64), (36, 50)),
                                     ((480, 640), (240, 320)), ((17, 23), (40, 9)),
                                     ((480, 640), (120, 160)), ((7, 5), (7, 5))])
def test_resizes_equal_cv2(src, dst):
    """Nearest: exact at every ratio. Bilinear on uint8: exact at 1x and an
    exact 2x reduction, within one level otherwise; the same dtype."""
    rng = np.random.RandomState(sum(src + dst))
    depth = (rng.rand(*src) * 60000).astype(np.uint16)
    color = (rng.rand(*src, 3) * 256).astype(np.uint8)
    np.testing.assert_array_equal(torch_base.resize_depth(depth, *dst, 5000.0),
                                  jax_base.resize_depth(depth, *dst, 5000.0))
    got = torch_base.resize_color(color, *dst, False)
    want = jax_base.resize_color(color, *dst, False)
    assert got.dtype == want.dtype == np.float32
    if dst == src or (src[0] == 2 * dst[0] and src[1] == 2 * dst[1]):
        np.testing.assert_array_equal(got, want)
    else:
        assert np.abs(got - want).max() <= 1.0


@pytest.mark.parametrize("args", [
    (12, 4, 1, 3, 2, None), (8, 4, None, None, None, None), (40, 6, None, None, None, None),
    (36, 4, 1, 3, None, None), (20, 3, 2, 5, 1, 17), (5, 5, None, None, None, None),
    (5, 6, None, None, None, None), (30, 1, 0, 1, 29, None),
])
def test_chunk_sequence_equals_jax(args):
    assert torch_base.chunk_sequence(*args) == jax_base.chunk_sequence(*args)


@pytest.mark.parametrize("args", [
    (8, 4, -1, None, None, None), (8, 4, None, None, 5, 3), (8, 0, None, None, None, None),
    (8, 4, None, 0, None, None), (8, 4, None, None, -1, None),
])
def test_chunk_sequence_refuses_like_jax(args):
    with pytest.raises(ValueError):
        jax_base.chunk_sequence(*args)
    with pytest.raises(ValueError):
        torch_base.chunk_sequence(*args)


def test_datautils_equal_jax():
    """Exact on random inputs."""
    rng = np.random.RandomState(0)
    img = (rng.rand(2, 5, 6, 3) * 255).astype(np.uint8)
    np.testing.assert_array_equal(torch_datautils.normalize_image(img),
                                  jax_datautils.normalize_image(img))
    np.testing.assert_array_equal(torch_datautils.channels_first(img),
                                  jax_datautils.channels_first(img))
    K = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    K[:, 0, 0], K[:, 1, 1], K[:, 0, 2], K[:, 1, 2] = 525.0, -480.0, 319.5, 239.5
    np.testing.assert_array_equal(torch_datautils.scale_intrinsics(K, 0.37, 0.5),
                                  jax_datautils.scale_intrinsics(K, 0.37, 0.5))
    pq = rng.randn(4, 7).astype(np.float32)
    pq[0, 3:] = 0  # the eps-guarded zero quaternion
    P = torch_datautils.pointquaternion_to_homogeneous(pq)
    np.testing.assert_array_equal(P, jax_datautils.pointquaternion_to_homogeneous(pq))
    np.testing.assert_array_equal(np.stack(torch_datautils.poses_to_transforms(P[1:])),
                                  np.stack(jax_datautils.poses_to_transforms(P[1:])))
    labels = rng.randint(-1, 5, (3, 4))
    np.testing.assert_array_equal(torch_datautils.labels_to_onehot(labels, 4),
                                  jax_datautils.labels_to_onehot(labels, 4))
    palette = {0: (0, 0, 0), 2: (255, 0, 0), 4: (1, 2, 3)}
    np.testing.assert_array_equal(torch_datautils.create_label_image(labels, palette),
                                  jax_datautils.create_label_image(labels, palette))


def test_tumutils_equal_jax(tmp_path):
    """``read_file_list``, ``associate`` (greedy by the smallest gap, at most
    ``max_difference``, offset applied), ``transform44`` (with its small-norm
    branch) and ``read_trajectory`` (NaN rows skipped), exactly."""
    a = tmp_path / "a.txt"
    a.write_text("# header\n1.00 a\n2.00 b\n3.00 c\n3.015 d\n4,00 e\n")
    b = tmp_path / "b.txt"
    b.write_text("1.01 x\n2.02 y\n3.01 z\n5.00 w\n3.02\tv\n")
    la, lb = torch_tumutils.read_file_list(str(a)), torch_tumutils.read_file_list(str(b))
    assert la == jax_tumutils.read_file_list(str(a)) and lb == jax_tumutils.read_file_list(str(b))
    for offset, gap in ((0.0, 0.02), (0.0, 0.05), (0.01, 0.02), (-0.5, 1.0)):
        assert (torch_tumutils.associate(la, lb, offset, gap)
                == jax_tumutils.associate(la, lb, offset, gap))
    for row in ([0.0, 1, 2, 3, 0, 0, 0, 0], [0.0, 1, 2, 3, 0.1, -0.2, 0.3, 0.9],
                [0.0, 0, 0, 0, 1e-9, 0, 0, 0]):
        np.testing.assert_array_equal(torch_tumutils.transform44(row),
                                      jax_tumutils.transform44(row))
    t = tmp_path / "traj.txt"
    t.write_text("1.0 0 0 0 0 0 0 1\n2.0 1 0 0 0.1 0 0 1\n3.0 nan 0 0 0 0 0 1\n")
    with pytest.warns(UserWarning):
        got = torch_tumutils.read_trajectory(str(t))
    with pytest.warns(UserWarning):
        want = jax_tumutils.read_trajectory(str(t))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    with pytest.warns(UserWarning):
        got = torch_tumutils.read_trajectory(str(t), matrix=False)
    with pytest.warns(UserWarning):
        want = jax_tumutils.read_trajectory(str(t), matrix=False)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_dataset_golden_holds_what_chip_smoke_reads():
    """The committed JAX CPU golden of the dataset phase
    (``tests/port/make_dataset_golden.py``) carries the keys and shapes
    ``chip_smoke.dataset_phase`` reads: each run's poses over the clip,
    nothing dropped, the ICL map at every pixel of the resized frames."""
    from ._cli import cs

    data = np.load(cs.DS_GOLDEN)
    for name in ("tum", "icl"):
        assert data[f"{name}_poses"].shape == (cs.DS_L, 4, 4)
        assert np.isfinite(data[f"{name}_poses"]).all()
        assert int(data[f"{name}_num_dropped"]) == 0
        assert 0 < float(data[f"{name}_ate_m"]) < 0.01
        assert 0 < float(data[f"{name}_ate_unaligned_m"]) < 0.01
    assert int(data["icl_num_points"]) == cs.DS_L * cs.ICL_H * cs.ICL_W
    assert 0.5 * cs.DS_H * cs.DS_W * cs.DS_L > int(data["tum_num_points"]) > cs.DS_H * cs.DS_W


@pytest.mark.parametrize("kw", [{}, {"channels_first": True}, {"normalize_color": True, "seed": 3}])
def test_synthetic_rgbd_samples_equal_jax(kw):
    from gradslam_torch.datasets import SyntheticRGBD as TorchSynthetic
    from gradslam_tpu.datasets import SyntheticRGBD as JaxSynthetic

    ours = TorchSynthetic(num_sequences=2, seqlen=3, height=24, width=32, **kw)
    theirs = JaxSynthetic(num_sequences=2, seqlen=3, height=24, width=32, **kw)
    assert len(ours) == len(theirs) == 2
    for idx in range(2):
        a, b = ours[idx], theirs[idx]
        assert len(a) == len(b) == 6 and a[-1] == b[-1]
        for t, arr in zip(a[:-1], b[:-1]):
            assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
            np.testing.assert_array_equal(t.numpy(), np.asarray(arr))
    with pytest.raises(IndexError):
        ours[2]
