"""The port's pipelines end to end: tracked ``PointFusion(odom='gradicp')``
and ``odom='gt'`` held against the JAX package on the same synthetic clip,
the reference goldens met without JAX, the unported options refused, and the
package importable with JAX absent.

Tolerances: poses within 1e-5 of JAX and map counts within 0.2% (float32
solves in another order); against the reference goldens the bars of the JAX
suite (``tests/slam/test_slam.py``, ``tests/examples/test_real_clip_e2e.py``)."""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import gradslam_tpu as G  # noqa: E402
from gradslam_torch import ICPSLAM, PointFusion, synthetic_sequence  # noqa: E402
from gradslam_tpu.datasets import synthetic_sequence as jax_synthetic_sequence  # noqa: E402

from ._parity import both_frames, golden, msrd  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.mark.parametrize("args", [(1, 4, 48, 64, 0, 1.0), (2, 3, 12, 20, 7, 4.0)])
def test_synthetic_sequence_equals_jax_package(args):
    B, L, H, W, seed, speed = args
    ours = synthetic_sequence(B, L, H, W, seed=seed, speed=speed)
    theirs = jax_synthetic_sequence(B, L, H, W, seed=seed, speed=speed)
    for a, b in zip(ours, theirs):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def _run_both(odom, **kw):
    rgb, depth, K, P = synthetic_sequence(1, 4, 48, 64)
    jf, tf = both_frames(rgb, depth, K, P)
    jpc, jposes = G.PointFusion(odom=odom, dsratio=4, numiters=10, **kw)(jf)
    tpc, tposes = PointFusion(odom=odom, dsratio=4, numiters=10, **kw)(tf)
    return (jpc, np.asarray(jposes)), (tpc, tposes.numpy()), P


@pytest.mark.parametrize("odom, schedule", [
    ("gradicp", None),
    ("gradicp", [(2, 4000), (2, 8000)]),
    ("gt", None),
])
def test_slice_matches_jax(odom, schedule):
    (jpc, jposes), (tpc, tposes), gt = _run_both(odom, map_capacity=schedule)
    assert tposes.shape == (1, 4, 4, 4)
    np.testing.assert_allclose(tposes, jposes, atol=1e-5, rtol=0)
    n_j, n_t = int(jpc.num_points[0]), int(tpc.num_points[0])
    assert abs(n_t - n_j) <= 0.002 * n_j
    assert int(tpc.num_dropped[0]) == int(jpc.num_dropped[0]) == 0
    if schedule is not None:
        assert tpc.capacity == schedule[-1][1]
    np.testing.assert_allclose(tpc.features_list[0].sum(),
                               np.asarray(jpc.features_list[0]).sum(), rtol=1e-5)
    # the synthetic clip is easy: tracking stays on the ground truth
    assert np.abs(tposes[0, :, :3, 3] - gt[0, :, :3, 3]).max() < 1e-3


def test_gradicp_meets_reference_golden_poses():
    m = msrd()
    _, tf = both_frames(m["colors"], m["depths"], m["intrinsics"], m["poses"])
    pc, poses = PointFusion(odom="gradicp", dsratio=4, numiters=20)(tf)
    assert np.abs(poses.numpy() - golden("pointfusion_gradicp_poses")).max() < 2e-3
    assert (pc.num_dropped == 0).all()


def _chamfer(a, b):
    from scipy.spatial import cKDTree

    da, _ = cKDTree(b).query(a)
    db, _ = cKDTree(a).query(b)
    return da.mean() + db.mean()


def test_gt_meets_reference_golden_map():
    m = msrd()
    _, tf = both_frames(m["colors"], m["depths"], m["intrinsics"], m["poses"])
    pc, poses = PointFusion(odom="gt")(tf)
    np.testing.assert_array_equal(poses.numpy(), m["poses"])
    for b in range(2):
        ref = golden(f"pointfusion_gt_points_{b}")
        ours = pc.points_list[b]
        assert abs(len(ours) - len(ref)) / len(ref) < 0.002
        assert _chamfer(ours, ref) < 1e-3
    np.testing.assert_allclose(pc.features_list[0].sum(),
                               golden("pointfusion_gt_ccounts_0").sum(), rtol=1e-4)


def test_pipeline_state_and_precision_policy():
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    slam = PointFusion(odom="gradicp")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    assert isinstance(slam, torch.nn.Module)
    pc = slam.empty_map(2, 7, device="cpu", dtype=torch.float64)
    assert pc.points.shape == (2, 7, 3) and pc.points.dtype == torch.float64
    assert pc.features.shape == (2, 7, 1) and pc.colors is not None
    assert slam._default_icp_capacity(480, 640) == 2 * 120 * 160


UNPORTED = [
    {"pyramid": [(4, 5), (2, 5)]},
    {"odom_assoc": "projective"},
    {"robust_loss": "huber"},
    {"odom_angle_gate": 30.0},
    {"motion_model": "constant_velocity"},
    {"relocalize_below": 0.5},
    {"anchor_every": 5},
    {"prune_every": 2},
    {"quantize_colors": True},
    {"feature_channels": 2},
    {"icp_window_frames": 3},
    {"lookahead_assoc": "reuse"},
    {"odom": "icp"},
    {"association": "windowed"},
    {"merge": "scatter"},
    {"active_capacity": 1000},
    {"remat": True},
]


@pytest.mark.parametrize("option", UNPORTED, ids=lambda o: next(iter(o)))
def test_unported_options_raise_naming_their_roadmap_item(option):
    with pytest.raises(NotImplementedError, match=r"ROADMAP\.md queue 1, item \d+"):
        PointFusion(**option)


def test_bad_arguments_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ICPSLAM(odom="gt")  # the aggregate map is not ported
    with pytest.raises(ValueError):
        PointFusion(odom="bogus")
    with pytest.raises(TypeError):
        PointFusion(not_an_option=1)
    with pytest.raises(ValueError):
        PointFusion(dsratio=0)
    rgb, depth, K, P = synthetic_sequence(1, 3, 8, 8)
    _, frames = both_frames(rgb, depth, K, None)
    with pytest.raises(ValueError, match="poses"):
        PointFusion(odom="gt")(frames)
    with pytest.raises(ValueError, match="covers"):
        PointFusion(odom="gt", map_capacity=[(2, 100)])(both_frames(rgb, depth, K, P)[1])


IMPORT_CHECK = r"""
import importlib, pkgutil, subprocess, sys

sys.modules["jax"] = None
sys.modules["gradslam_tpu"] = None


def refuse(*args, **kwargs):
    raise AssertionError(f"a process was started: {args!r}")


subprocess.run = subprocess.Popen = refuse

import gradslam_torch
from gradslam_torch import PointFusion, synthetic_sequence
from gradslam_torch.interop import rgbdimages_from_numpy
from gradslam_torch.ops import _build

for mod in pkgutil.walk_packages(gradslam_torch.__path__, "gradslam_torch."):
    importlib.import_module(mod.name)
frames = rgbdimages_from_numpy(*synthetic_sequence(1, 2, 16, 24))
pc, poses = PointFusion(odom="gradicp", numiters=2)(frames)
assert _build.load_library.cache_info().currsize == 0
loaded = [n for n, m in sys.modules.items() if m is not None]
assert not [n for n in loaded if n.split(".")[0] in ("jax", "jaxlib", "gradslam_tpu")]
print("ok", int(pc.num_points[0]), tuple(poses.shape))
"""


def test_package_imports_and_runs_without_jax_or_a_compiler():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", IMPORT_CHECK], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.startswith("ok ") and "(1, 2, 4, 4)" in out.stdout
