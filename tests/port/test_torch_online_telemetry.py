"""The port's ``online_slam`` example CLI against the JAX package's with
its telemetry and map maintenance on: ``--health-every`` (tracking-health
lines every frame), ``--prune-every`` and ``--export-voxel-size``, on the
tiny TUM tree of ``test_torch_online_slam.py`` at 48x64. Tolerances as
there (``tests/port/_cli.py``): the printed output with map counts within
0.2% and decimals within 1e-5, final poses within 1e-5, map counts within
0.2%, the trajectory files within 1e-5."""

import pytest

pytest.importorskip("jax")

from ._cli import check_online_cli, cs  # noqa: E402


@pytest.fixture(scope="module")
def tum(tmp_path_factory):
    root = tmp_path_factory.mktemp("online_tree")
    return str(cs.write_tum_tree(root, cs.dataset_clip(cs.TUM_INTRINSICS, (6, 48, 64))))


def test_health_prune_and_voxel_export_match_jax(tum, tmp_path, monkeypatch, capsys):
    out = check_online_cli(
        ["--dataset_path", tum, "--height", "48", "--width", "64", "--odometry", "gradicp",
         "--seqlen", "4", "--health-every", "1", "--prune-every", "2",
         "--prune-min-confidence", "0.5", "--export-voxel-size", "0.05"],
        tmp_path, monkeypatch, capsys)
    assert out.count("  health: inliers") == 4 and "voxel decimation @ 0.05 m" in out
