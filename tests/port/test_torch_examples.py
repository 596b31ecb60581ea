"""The port's ``pointfusion`` example CLI
(``gradslam_torch/examples/pointfusion.py``) against the JAX package's
(``examples/pointfusion.py``) on tiny TUM and ICL
trees: 48x64 files of ``chip_smoke.dataset_clip`` (the synthetic wall at
each dataset's intrinsics) loaded at 24x32. Each CLI's ``main`` runs on the
CPU and must print what the JAX CLI prints (numbers within the bars of
``tests/port/_cli.py``: map counts within 0.2%, metres within 1e-5) and
give poses within 1e-5 and maps within 0.2% (points within 1e-5 where the
counts are equal)."""

import pytest

pytest.importorskip("jax")

from gradslam_torch.examples import pointfusion  # noqa: E402

from ._cli import (  # noqa: E402
    assert_same_output,
    assert_same_run,
    cs,
    run_jax_example,
    run_port_example,
)

SHAPE = (6, 48, 64)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_trees")
    return {
        "tum": str(cs.write_tum_tree(root / "tum", cs.dataset_clip(cs.TUM_INTRINSICS, SHAPE))),
        "icl": str(cs.write_icl_tree(root / "icl", cs.dataset_clip(cs.ICL_INTRINSICS, SHAPE))),
    }


SMALL = ["--height", "24", "--width", "32", "--seqlen", "3", "--batch_size", "1"]
POINTFUSION_CASES = {
    "gt": ["--odometry", "gt"],
    "gradicp": ["--odometry", "gradicp"],
    "icp_batch2": ["--odometry", "icp", "--batch_size", "2"],
    "quantized": ["--odometry", "gt", "--quantize-colors"],
    "projective_robust_cv": [
        "--odometry", "gradicp", "--odom-assoc", "projective", "--odom-sym-normals",
        "--odom-point-weight", "0.25", "--odom-angle-gate", "45", "--robust-loss", "tukey",
        "--robust-scale", "0.03", "--dist-thresh", "0.01",
        "--motion-model", "constant_velocity", "--normal-pitch", "2"],
    "hybrid_prune": [
        "--odometry", "gradicp", "--pyramid", "4:3,2:2", "--odom-assoc", "projective,knn",
        "--odom-sym-normals", "--prune-every", "2", "--prune-min-confidence", "0.5"],
    "subpixel_relocalize": [
        "--odometry", "gradicp", "--odom-assoc", "projective", "--odom-subpixel",
        "--relocalize-below", "0.2", "--anchor-every", "2"],
}


# every option set on the TUM tree, the plain odometries on the ICL one
PF_RUNS = [(c, "tum") for c in POINTFUSION_CASES] + [("gt", "icl"), ("gradicp", "icl")]


@pytest.mark.parametrize("case,dataset", PF_RUNS)
def test_pointfusion_cli_matches_jax(trees, case, dataset, monkeypatch, capsys):
    argv = ["--dataset", dataset, "--dataset_path", trees[dataset], *SMALL,
            *POINTFUSION_CASES[case]]
    jax_out, jax_calls = run_jax_example("pointfusion", argv, monkeypatch, capsys)
    port_out, port_result = run_port_example(pointfusion, argv, capsys)
    assert_same_output(jax_out, port_out)
    assert "map points per sequence" in port_out and "WARNING" not in port_out
    assert_same_run(jax_calls[0], port_result)


def test_pointfusion_cli_reads_a_config_file(trees, tmp_path, monkeypatch, capsys):
    """``--config`` merges a YAML file over the flags (odometry gt, 4
    frames), as the JAX CLI does."""
    pytest.importorskip("yaml")
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text("odometry: gt\nseqlen: 4\n")
    argv = ["--dataset", "tum", "--dataset_path", trees["tum"], *SMALL, "--config", str(cfg)]
    jax_out, jax_calls = run_jax_example("pointfusion", argv, monkeypatch, capsys)
    port_out, port_result = run_port_example(pointfusion, argv, capsys)
    assert_same_output(jax_out, port_out)
    assert "(1, 4, 4, 4)" in port_out
    assert_same_run(jax_calls[0], port_result)
