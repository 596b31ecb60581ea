"""The port reads and writes its files without the image and config
libraries the JAX package leans on. In a fresh interpreter where ``jax``,
``gradslam_tpu``, ``cv2``, ``imageio``, ``PIL``, ``yaml`` and
``torchvision`` cannot be imported, every module of ``gradslam_torch`` and
``chip_smoke.py`` imports, the pointfusion and online_slam CLIs run on the
CPU from a TUM tree the port's encoder wrote to a map, a PLY, a trajectory
and a checkpoint, and none of those libraries is loaded afterwards."""

import os
import subprocess
import sys

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))

CHECK = r"""
import importlib, pkgutil, sys, tempfile
from pathlib import Path

BLOCKED = ("jax", "jaxlib", "gradslam_tpu", "cv2", "imageio", "PIL", "yaml", "torchvision")
for name in BLOCKED:
    sys.modules[name] = None

import gradslam_torch
for mod in pkgutil.walk_packages(gradslam_torch.__path__, "gradslam_torch."):
    importlib.import_module(mod.name)
import chip_smoke as cs
from gradslam_torch.examples import online_slam, pointfusion
from gradslam_torch.structures import load_ply
from gradslam_torch.utils import load_state, load_trajectory_tum

with tempfile.TemporaryDirectory() as tmp:
    root = cs.write_tum_tree(Path(tmp) / "tum", cs.dataset_clip(cs.TUM_INTRINSICS, (3, 24, 32)))
    pc, poses = pointfusion.main(["--dataset", "tum", "--dataset_path", str(root), "--seqlen",
                                  "3", "--batch_size", "1", "--height", "24", "--width", "32",
                                  "--odometry", "gradicp", "--cpu"])
    out = str(Path(tmp) / "out")
    opc, est = online_slam.main(["--dataset_path", str(root), "--seqlen", "3", "--height",
                                 "24", "--width", "32", "--odometry", "icp", "--out", out,
                                 "--cpu"])
    n = int(opc.num_points[0])
    assert load_ply(out + "/map.ply")["points"].shape == (n, 3)
    assert load_trajectory_tum(out + "/trajectory.txt")[1].shape == (3, 4, 4)
    assert int(load_state(out + "/state.npz", device="cpu")[0].num_points[0]) == n
loaded = [n for n, m in sys.modules.items() if m is not None]
assert not [n for n in loaded if n.split(".")[0] in BLOCKED], loaded
print("ok", int(pc.num_points[0]), tuple(poses.shape))
"""


def test_port_runs_from_disk_without_image_or_yaml_libraries():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", CHECK], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "ok " in out.stdout and "(1, 3, 4, 4)" in out.stdout
