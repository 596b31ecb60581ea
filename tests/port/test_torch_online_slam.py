"""The port's ``online_slam`` example CLI (``gradslam_torch/examples/
online_slam.py``) against the JAX package's (``examples/online_slam.py``)
on a tiny TUM tree (6 frames of ``chip_smoke.dataset_clip`` at 48x64; at
24x32 the 1-NN level has 48 points and the ICP solves amplify ulp
differences past 1e-5, except in the one relocalized frame of the
relocalization case, which runs at 24x32 to keep the JAX CLI's compile
short; a size flag given twice: the last wins).

Tolerances: the printed output as ``tests/port/_cli.py`` holds it (map
counts within 0.2%, decimals within 1e-5); the final state's poses within
1e-5 of JAX's and its map count within 0.2%; the trajectory files read back
within 1e-5 of each other.
"""

import pytest

pytest.importorskip("jax")

from ._cli import check_online_cli, cs  # noqa: E402


from ._threads import one_thread  # noqa: E402,F401


SMALL = ["--height", "48", "--width", "64"]


@pytest.fixture(scope="module")
def tum(tmp_path_factory):
    root = tmp_path_factory.mktemp("online_tree")
    return str(cs.write_tum_tree(root, cs.dataset_clip(cs.TUM_INTRINSICS, (6, 48, 64))))


CASES = {
    "gt_checkpoint": ["--odometry", "gt", "--seqlen", "4", "--checkpoint-every", "2",
                      "--map_capacity", "4000"],
    "icp_constant_velocity": ["--odometry", "icp", "--seqlen", "3",
                              "--motion-model", "constant_velocity"],
    "gradicp_relocalize": ["--odometry", "gradicp", "--seqlen", "2",
                           "--relocalize-below", "1.01", "--height", "24", "--width", "32"],
}


@pytest.mark.parametrize("case", list(CASES))
def test_online_cli_matches_jax(tum, tmp_path, case, monkeypatch, capsys):
    check_online_cli(["--dataset_path", tum, *SMALL, *CASES[case]], tmp_path, monkeypatch,
                     capsys)
