"""The port's ``icpslam`` example CLI (``gradslam_torch/examples/
icpslam.py``) against the JAX package's (``examples/icpslam.py``) on tiny
TUM and ICL trees (48x64 files of ``chip_smoke.dataset_clip`` loaded at
24x32), and every example CLI's flags against its JAX counterpart's. Each
``main`` runs on the CPU and must print what the JAX CLI prints (numbers
within the bars of ``tests/port/_cli.py``: map counts within 0.2%, metres
within 1e-5) and give poses within 1e-5 and maps within 0.2% (points
within 1e-5 where the counts are equal)."""

import importlib
import os

import pytest

pytest.importorskip("jax")

from gradslam_torch.examples import icpslam  # noqa: E402

from ._cli import (  # noqa: E402
    REPO,
    assert_same_output,
    assert_same_run,
    cs,
    run_jax_example,
    run_port_example,
)

SHAPE = (6, 48, 64)
SMALL = ["--height", "24", "--width", "32", "--seqlen", "3", "--batch_size", "1"]


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_trees")
    return {
        "tum": str(cs.write_tum_tree(root / "tum", cs.dataset_clip(cs.TUM_INTRINSICS, SHAPE))),
        "icl": str(cs.write_icl_tree(root / "icl", cs.dataset_clip(cs.ICL_INTRINSICS, SHAPE))),
    }


ICPSLAM_CASES = {
    "gt": ["--odometry", "gt"],
    "icp": ["--odometry", "icp"],
    "gradicp_window": ["--odometry", "gradicp", "--icp-window-frames", "1"],
    "projective": ["--odometry", "icp", "--odom-assoc", "projective", "--odom-sym-normals",
                   "--odom-point-weight", "0.25", "--odom-subpixel"],
}


@pytest.mark.parametrize("dataset", ["tum", "icl"])
@pytest.mark.parametrize("case", list(ICPSLAM_CASES))
def test_icpslam_cli_matches_jax(trees, case, dataset, monkeypatch, capsys):
    argv = ["--dataset", dataset, "--dataset_path", trees[dataset], *SMALL,
            *ICPSLAM_CASES[case]]
    jax_out, jax_calls = run_jax_example("icpslam", argv, monkeypatch, capsys)
    port_out, port_result = run_port_example(icpslam, argv, capsys)
    assert_same_output(jax_out, port_out)
    assert "ATE-RMSE vs GT" in port_out
    assert_same_run(jax_calls[0], port_result)


def _jax_parser(name):
    """The argument parser of ``examples/<name>.py``, built from its source
    without running the script (its module level parses ``sys.argv``)."""
    import argparse

    with open(os.path.join(REPO, "examples", f"{name}.py")) as f:
        src = f.read()
    body = src.split("parser = argparse.ArgumentParser()", 1)[1]
    body = body.split("args = parser.parse_args()", 1)[0]
    scope = {"argparse": argparse}
    exec("parser = argparse.ArgumentParser()" + body, scope)
    return scope["parser"]


@pytest.mark.parametrize("name", ["pointfusion", "icpslam", "online_slam",
                                  "pointfusion_scannet", "icpslam_scannet"])
def test_cli_flags_equal_jax(name):
    """Every flag of the JAX CLI with its default, choices and whether it
    is required, plus ``--cpu``."""
    module = importlib.import_module(f"gradslam_torch.examples.{name}")

    def flags(parser):
        return {a.dest: (tuple(a.option_strings), a.default, a.required,
                         tuple(a.choices or ())) for a in parser._actions}

    got = flags(module.parser)
    assert got.pop("cpu") == (("--cpu",), False, False, ())
    assert got == flags(_jax_parser(name))
