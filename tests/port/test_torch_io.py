"""The port's file IO against the JAX package's: PLY (both formats, each
package's file read by the other's reader), ``Pointclouds.save_ply``, TUM
trajectories, checkpoints (a map carried across in a file), the CLI spec
parser, and the profiling hooks on the CPU.

Tolerances: PLY points and normals are float32 in the file and read back
bit for bit; colours are uchar and equal as bytes. A trajectory round trip
is within 1e-6 (nine decimals in the port's file, six in the JAX
package's: within 1e-5 there). Checkpoints carry float32 buffers and poses
bit for bit and the counters exactly.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import gradslam_tpu as G  # noqa: E402
from gradslam_torch import Pointclouds as TorchPointclouds  # noqa: E402
from gradslam_torch.interop import pointclouds_from_numpy, to_numpy  # noqa: E402
from gradslam_torch.structures import io as torch_io  # noqa: E402
from gradslam_torch.utils import checkpoint as torch_ckpt  # noqa: E402
from gradslam_torch.utils import cli as torch_cli  # noqa: E402
from gradslam_torch.utils import profiling  # noqa: E402
from gradslam_torch.utils import trajectory_io as torch_traj  # noqa: E402
from gradslam_tpu.structures import io as jax_io  # noqa: E402
from gradslam_tpu.utils import checkpoint as jax_ckpt  # noqa: E402
from gradslam_tpu.utils import cli as jax_cli  # noqa: E402
from gradslam_tpu.utils import trajectory_io as jax_traj  # noqa: E402


@pytest.fixture
def cloud():
    rng = np.random.RandomState(0)
    pts = rng.randn(100, 3).astype(np.float32)
    nrm = rng.randn(100, 3).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    return pts, nrm, rng


COLORS = {
    "unit_float": lambda rng: rng.rand(100, 3).astype(np.float32),
    "byte_float": lambda rng: (rng.rand(100, 3) * 255).astype(np.float32),
    "uint8": lambda rng: (rng.rand(100, 3) * 256).astype(np.uint8),
    "int32": lambda rng: rng.randint(-5, 300, (100, 3)).astype(np.int32),
    "out_of_range_float": lambda rng: (rng.rand(100, 3) * 3 - 1).astype(np.float32),
    "none": lambda rng: None,
}


def _equal(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("color_range", [None, "unit", "byte"])
@pytest.mark.parametrize("colors", list(COLORS))
@pytest.mark.parametrize("binary", [True, False])
def test_ply_files_read_equal_across_packages(tmp_path, cloud, binary, colors, color_range):
    """Each package writes the same cloud; both files read equal in both
    readers, and the two packages' files are the same bytes."""
    pts, nrm, rng = cloud
    col = COLORS[colors](rng)
    if colors == "byte_float" and color_range is None:
        color_range = "byte"  # the dtype convention would clip them (JAX warns)
    paths = {}
    for name, mod in (("jax", jax_io), ("torch", torch_io)):
        paths[name] = str(tmp_path / f"{name}.ply")
        mod.save_ply(paths[name], pts, normals=nrm, colors=col, binary=binary,
                     color_range=color_range)
    with open(paths["jax"], "rb") as f, open(paths["torch"], "rb") as g:
        assert f.read() == g.read()
    ref = jax_io.load_ply(paths["jax"])
    for path in paths.values():
        _equal(torch_io.load_ply(path), ref)
        _equal(jax_io.load_ply(path), ref)
    if binary:
        np.testing.assert_array_equal(ref["points"], pts)
        np.testing.assert_array_equal(ref["normals"], nrm)


def test_ply_refusals_match_jax(tmp_path, cloud):
    pts, nrm, _ = cloud
    for mod in (jax_io, torch_io):
        with pytest.raises(ValueError):
            mod.save_ply(str(tmp_path / "x.ply"), pts[:, :2])
        with pytest.raises(ValueError):
            mod.save_ply(str(tmp_path / "x.ply"), pts, normals=nrm[:50])
        with pytest.raises(ValueError):
            mod.save_ply(str(tmp_path / "x.ply"), pts, color_range="percent")
    bogus = tmp_path / "bogus.ply"
    bogus.write_text("hello\nworld\n")
    truncated = tmp_path / "truncated.ply"
    truncated.write_text("ply\nformat ascii 1.0\nelement vertex 2\nproperty float x\n")
    for path in (bogus, truncated):
        for mod in (jax_io, torch_io):
            with pytest.raises(ValueError):
                mod.load_ply(str(path))


def test_pointclouds_save_ply_equals_jax(tmp_path, cloud):
    """``Pointclouds.save_ply`` of batch element 1 of a padded two-cloud
    buffer writes the same bytes as the JAX method, and only live rows."""
    pts, nrm, rng = cloud
    col = rng.rand(100, 3).astype(np.float32)
    jpc = G.Pointclouds.from_list(points=[pts[:60], pts[60:]], normals=[nrm[:60], nrm[60:]],
                                  colors=[col[:60], col[60:]], capacity=70)
    tpc = pointclouds_from_numpy(np.asarray(jpc.points), np.asarray(jpc.num_points),
                                 normals=np.asarray(jpc.normals),
                                 colors=np.asarray(jpc.colors), device="cpu")
    for binary in (True, False):
        jpc.save_ply(str(tmp_path / "j.ply"), index=1, binary=binary)
        tpc.save_ply(str(tmp_path / "t.ply"), index=1, binary=binary)
        with open(tmp_path / "j.ply", "rb") as f, open(tmp_path / "t.ply", "rb") as g:
            assert f.read() == g.read()
    out = torch_io.load_ply(str(tmp_path / "t.ply"))
    assert out["points"].shape == (40, 3)
    bare = TorchPointclouds(points=tpc.points, num_points=tpc.num_points)
    bare.save_ply(str(tmp_path / "bare.ply"), index=0)
    assert set(torch_io.load_ply(str(tmp_path / "bare.ply"))) == {"points"}


def _poses(n=6, seed=0):
    rng = np.random.RandomState(seed)
    xi = np.concatenate([rng.randn(n, 3) * 0.5, rng.randn(n, 3) * 1.2], axis=1)
    poses = np.array(G.se3_exp(jnp.asarray(xi, jnp.float32)))
    poses[0] = np.diag([-1.0, -1.0, 1.0, 1.0])  # trace -1: Shepperd's other branches
    poses[1] = np.diag([1.0, -1.0, -1.0, 1.0])
    poses[2] = np.diag([-1.0, 1.0, -1.0, 1.0])
    return poses.astype(np.float32)


def test_trajectory_files_load_equal_across_packages(tmp_path):
    """A file from either writer loads the same in both readers (stamps
    and poses exactly); the port's round trip is within 1e-6, the JAX
    package's six-decimal one within 1e-5."""
    poses = _poses()
    stamps = 1000.0 + 0.05 * np.arange(len(poses))
    torch_traj.save_trajectory_tum(str(tmp_path / "t.txt"), torch.from_numpy(poses), stamps)
    jax_traj.save_trajectory_tum(str(tmp_path / "j.txt"), poses, stamps)
    for name, atol in (("t.txt", 1e-6), ("j.txt", 1e-5)):
        path = str(tmp_path / name)
        ts, tp = torch_traj.load_trajectory_tum(path)
        js, jp = jax_traj.load_trajectory_tum(path)
        np.testing.assert_array_equal(ts, js)
        assert tp.dtype == jp.dtype == np.float32
        np.testing.assert_array_equal(tp, jp)
        np.testing.assert_allclose(ts, stamps, atol=1e-6)
        np.testing.assert_allclose(tp, poses, atol=atol, rtol=0)
    for mod in (torch_traj, jax_traj):
        with pytest.raises(ValueError):
            mod.save_trajectory_tum(str(tmp_path / "x.txt"), np.zeros((5, 3, 4)))


def _jax_map(seed=0):
    rng = np.random.RandomState(seed)
    pts = [rng.randn(n, 3).astype(np.float32) for n in (5, 3)]
    return G.Pointclouds.from_list(
        pts, normals=[rng.randn(*p.shape).astype(np.float32) for p in pts],
        colors=[rng.rand(*p.shape).astype(np.float32) for p in pts],
        features=[rng.rand(p.shape[0], 2).astype(np.float32) for p in pts], capacity=8)


@pytest.mark.parametrize("with_poses", [True, False])
def test_checkpoints_load_equal_across_packages(tmp_path, with_poses):
    """A JAX checkpoint loads into the port (on the CPU when asked) with
    every buffer and the poses bit-equal, and the port's checkpoint of that
    map loads back into the JAX package equal to the original; the port's
    file holds the JAX file's keys."""
    jpc = _jax_map()
    poses = jnp.asarray(_poses(4)) if with_poses else None
    jax_ckpt.save_state(str(tmp_path / "j.npz"), jpc, poses)
    tpc, tposes = torch_ckpt.load_state(str(tmp_path / "j.npz"), device="cpu")
    assert tpc.device.type == "cpu" and tpc.num_points.dtype == torch.int64
    got = to_numpy(tpc)
    for name in ("points", "normals", "colors", "features", "num_points"):
        np.testing.assert_array_equal(got[name], np.asarray(getattr(jpc, name)))
    assert got["num_dropped"] is None  # from_list tracks no drops
    if with_poses:
        assert tposes.dtype == torch.float32
        np.testing.assert_array_equal(tposes.numpy(), np.asarray(poses))
    else:
        assert tposes is None
    torch_ckpt.save_state(str(tmp_path / "t"), tpc, tposes)  # ".npz" added
    with np.load(tmp_path / "t.npz") as a, np.load(tmp_path / "j.npz") as b:
        assert set(a.files) == set(b.files)
    jpc2, jposes2 = jax_ckpt.load_state(str(tmp_path / "t.npz"))
    for name in ("points", "normals", "colors", "features", "num_points"):
        np.testing.assert_array_equal(np.asarray(getattr(jpc2, name)),
                                      np.asarray(getattr(jpc, name)))
    if with_poses:
        np.testing.assert_array_equal(np.asarray(jposes2), np.asarray(poses))
    assert not (tmp_path / "t.npz.tmp").exists()


def test_checkpoint_round_trip_keeps_drops_and_defaults_to_the_card(tmp_path, monkeypatch):
    """``num_dropped`` survives the port's round trip; without ``device``
    the state is put on the card (the tensors are made on the CUDA device,
    which the CPU build cannot make: the call is watched, not run)."""
    pc = TorchPointclouds.empty(2, 6, device="cpu")
    pc = pc.append_masked(torch.randn(2, 9, 3), torch.ones(2, 9, dtype=torch.bool),
                          normals=torch.randn(2, 9, 3))
    torch_ckpt.save_state(str(tmp_path / "s.npz"), pc)
    back, poses = torch_ckpt.load_state(str(tmp_path / "s"), device="cpu")
    assert poses is None
    np.testing.assert_array_equal(back.num_dropped.numpy(), [3, 3])
    np.testing.assert_array_equal(back.points.numpy(), pc.points.numpy())
    seen = []
    monkeypatch.setattr(torch_ckpt, "pointclouds_from_numpy",
                        lambda *a, **k: seen.append(k["device"]) or pc)
    torch_ckpt.load_state(str(tmp_path / "s.npz"))
    assert seen == ["cuda"]


@pytest.mark.parametrize("spec", [None, "8:6,4:4", "2:10", "8:a", "8:6:2", "", "4:3,"])
def test_parse_pyramid_equals_jax(spec):
    """The same levels, or the same ``SystemExit`` message."""
    try:
        want = jax_cli.parse_pyramid(spec)
    except SystemExit as e:
        with pytest.raises(SystemExit) as got:
            torch_cli.parse_pyramid(spec)
        assert str(got.value) == str(e)
    else:
        assert torch_cli.parse_pyramid(spec) == want


def test_profiling_hooks_on_the_cpu(tmp_path, capsys):
    """``trace`` writes a trace file holding an ``annotate`` range;
    ``device_timer`` appends its seconds and prints its label."""
    log_dir = tmp_path / "trace"
    with profiling.trace(str(log_dir), device="cpu"):
        with profiling.annotate("fusion_step"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    files = list(log_dir.glob("*.json"))
    assert len(files) == 1 and "fusion_step" in files[0].read_text()
    box = []
    with profiling.device_timer("step", box, device="cpu") as b:
        assert b is box
        torch.ones(8).sum()
    assert len(box) == 1 and box[0] >= 0
    assert "[device_timer] step:" in capsys.readouterr().out
