"""The port's ScanNet example CLIs (``gradslam_torch/examples/
pointfusion_scannet.py``, ``icpslam_scannet.py``) against the JAX package's
(``examples/pointfusion_scannet.py``, ``icpslam_scannet.py``) on the fake
scene of ``tests/examples/test_examples_cli.py`` (JPEG colour, 16-bit depth
in millimetres, 8-bit nyu40 labels, a pose file a frame), here rendered from
``chip_smoke.dataset_clip``'s wall so that tracking has a surface to lock
on. Each CLI's ``main`` runs on the CPU and must print what the JAX CLI
prints (map counts within 0.2%, decimals within 1e-5; each fused class
count within 0.2% of the map's points, since a point that fuses or takes
its argmax differently moves one count between classes) and give poses
within 1e-5 and maps within 0.2%."""

import numpy as np
import pytest

imageio = pytest.importorskip("imageio.v2")
pytest.importorskip("jax")

from gradslam_torch.examples import icpslam_scannet, pointfusion_scannet  # noqa: E402

from ._cli import (  # noqa: E402
    assert_same_output,
    assert_same_run,
    cs,
    run_jax_example,
    run_port_example,
)


@pytest.fixture(scope="module")
def scannet(tmp_path_factory):
    root = tmp_path_factory.mktemp("scannet_cli")
    scans, meta = root / "scans", root / "seqmeta"
    scene = scans / "scene0000_00"
    for sub in ("color", "depth", "pose", "label-filt", "intrinsic"):
        (scene / sub).mkdir(parents=True)
    meta.mkdir()
    K = (400.0, 400.0, 319.5, 239.5)
    colors, depths, poses = cs.dataset_clip(K, (5, 48, 64))
    np.savetxt(str(scene / "intrinsic" / "intrinsic_depth.txt"),
               np.diag([K[0], K[1], 1.0, 1.0]) + np.array(
                   [[0, 0, K[2], 0], [0, 0, K[3], 0], [0, 0, 0, 0], [0, 0, 0, 0]]))
    rng = np.random.RandomState(0)
    lines = []
    for i in range(len(colors)):
        imageio.imwrite(str(scene / "color" / f"{i}.jpg"), colors[i])
        # millimetres, as ScanNet stores depth
        imageio.imwrite(str(scene / "depth" / f"{i}.png"),
                        (depths[i].astype(np.float64) / 5).round().astype(np.uint16))
        imageio.imwrite(str(scene / "label-filt" / f"{i}.png"),
                        rng.randint(0, 41, (48, 64)).astype(np.uint8))
        np.savetxt(str(scene / "pose" / f"{i}.txt"), poses[i])
        lines.append(
            f"color scene0000_00/color/{i}.jpg depth scene0000_00/depth/{i}.png "
            f"pose scene0000_00/pose/{i}.txt "
            f"label-filt scene0000_00/label-filt/{i}.png "
            f"intrinsic_color x extrinsic_color y extrinsic_depth z "
            f"intrinsic_depth scene0000_00/intrinsic/intrinsic_depth.txt")
    (meta / "scene0000_00-seq_0.txt").write_text("\n".join(lines))
    return str(scans), str(meta)


SMALL = ["--height", "24", "--width", "32", "--start", "0", "--end", "3"]
CASES = {
    "pointfusion_scannet": {"gt": ["--odometry", "gt"],
                            "fuse_labels": ["--odometry", "gt", "--fuse-labels"],
                            "gradicp_scene": ["--odometry", "gradicp",
                                              "--scenes", "scene0000_00"]},
    "icpslam_scannet": {"gradicp": [], "icp": ["--odometry", "icp"]},
}
MODULES = {"pointfusion_scannet": pointfusion_scannet, "icpslam_scannet": icpslam_scannet}


@pytest.mark.parametrize("name,case", [(n, c) for n in CASES for c in CASES[n]])
def test_scannet_cli_matches_jax(scannet, name, case, monkeypatch, capsys):
    scans, meta = scannet
    argv = ["--dataset_path", scans, "--seqmeta_path", meta, *SMALL, *CASES[name][case]]
    jax_out, jax_calls = run_jax_example(name, argv, monkeypatch, capsys)
    port_out, port_result = run_port_example(MODULES[name], argv, capsys)
    head = "fused map class counts:"
    if case == "fuse_labels":
        jax_out, jax_classes = jax_out.split(head)
        port_out, port_classes = port_out.split(head)
        jc, pc = _class_counts(jax_classes), _class_counts(port_classes)
        total = int(port_result[0].num_points[0])
        assert jc.keys() == pc.keys()
        assert all(abs(jc[k] - pc[k]) <= 0.002 * total for k in jc), (jc, pc)
    assert_same_output(jax_out, port_out)
    assert "map points:" in port_out
    assert_same_run(jax_calls[0], port_result)


def _class_counts(text):
    """``{class: count}`` of the CLI's ``  name: count`` lines."""
    rows = [line.split(":") for line in text.strip().splitlines()]
    return {name.strip(): int(count) for name, count in rows}
