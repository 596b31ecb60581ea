"""Checkpoint and resume through the port's ``online_slam`` example CLI
(``gradslam_torch/examples/online_slam.py``) on a tiny TUM tree (6 frames of
``chip_smoke.dataset_clip`` at 48x64, loaded at 24x32; the JAX checkpoint
case at 48x64, where the ICP solves do not amplify ulp differences past
1e-5).

Tolerances: the port's resumed run equals its uninterrupted run bit for bit
(poses, map buffers, counters), its ``map.ply`` reads back as the map's
live rows bit for bit and its ``trajectory.txt`` within 1e-6 of the poses.
A JAX checkpoint resumed by the port ends within 1e-5 of the JAX CLI's
uninterrupted run (poses), map counts within 0.2%.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

from gradslam_torch.examples import online_slam  # noqa: E402
from gradslam_torch.structures.io import load_ply  # noqa: E402
from gradslam_torch.utils.trajectory_io import load_trajectory_tum  # noqa: E402

from ._cli import (  # noqa: E402
    COUNT_REL,
    FLOAT_ATOL,
    cs,
    online_state,
    run_jax_example,
    run_port_example,
)

SMALL = ["--height", "24", "--width", "32"]


@pytest.fixture(scope="module")
def tum(tmp_path_factory):
    root = tmp_path_factory.mktemp("online_tree")
    return str(cs.write_tum_tree(root, cs.dataset_clip(cs.TUM_INTRINSICS, (6, 48, 64))))


@pytest.mark.parametrize("odometry", [
    ["--odometry", "gradicp"],
    ["--odometry", "icp", "--motion-model", "constant_velocity"],
])
def test_resume_equals_the_uninterrupted_run(tum, tmp_path, odometry, capsys):
    """4 frames straight through (checkpointing every 2), against 2 frames
    then ``--resume`` to 4: the final state bit for bit; then the exports
    of the resumed run read back."""
    whole, split = str(tmp_path / "whole"), str(tmp_path / "split")
    common = ["--dataset_path", tum, *SMALL, *odometry]
    run_port_example(online_slam, [*common, "--seqlen", "4", "--checkpoint-every", "2",
                                   "--out", whole], capsys)
    run_port_example(online_slam, [*common, "--seqlen", "2", "--out", split], capsys)
    out, (pc, est) = run_port_example(
        online_slam, [*common, "--seqlen", "4", "--resume", "--out", split], capsys)
    assert "resumed from" in out and "at frame 2" in out and "growing map capacity" in out
    (apc, aposes), (bpc, bposes) = online_state(whole), online_state(split)
    np.testing.assert_array_equal(bposes, aposes)
    for name in ("points", "normals", "colors", "features", "num_points", "num_dropped"):
        np.testing.assert_array_equal(getattr(bpc, name).numpy(), getattr(apc, name).numpy())
    n = int(pc.num_points[0])
    cloud = load_ply(f"{split}/map.ply")
    np.testing.assert_array_equal(cloud["points"], pc.points[0, :n].numpy())
    np.testing.assert_array_equal(cloud["normals"], pc.normals[0, :n].numpy())
    _, traj = load_trajectory_tum(f"{split}/trajectory.txt")
    np.testing.assert_allclose(traj, est.numpy(), atol=1e-6, rtol=0)


def test_port_resumes_a_jax_checkpoint(tum, tmp_path, monkeypatch, capsys):
    """The JAX CLI's checkpoint after 2 frames, resumed by the port's CLI
    to 4: poses within 1e-5 of the JAX CLI's uninterrupted run, map counts
    within 0.2%."""
    jax_whole, shared = str(tmp_path / "jax_whole"), str(tmp_path / "shared")
    common = ["--dataset_path", tum, "--height", "48", "--width", "64", "--odometry", "icp"]
    run_jax_example("online_slam", [*common, "--seqlen", "4", "--out", jax_whole],
                    monkeypatch, capsys)
    run_jax_example("online_slam", [*common, "--seqlen", "2", "--out", shared],
                    monkeypatch, capsys)
    out, _ = run_port_example(online_slam,
                              [*common, "--seqlen", "4", "--resume", "--out", shared], capsys)
    assert "resumed from" in out
    (jpc, jposes), (tpc, tposes) = online_state(jax_whole), online_state(shared)
    np.testing.assert_allclose(tposes, jposes, atol=FLOAT_ATOL, rtol=0)
    n_j, n_t = int(jpc.num_points[0]), int(tpc.num_points[0])
    assert abs(n_t - n_j) <= COUNT_REL * n_j
