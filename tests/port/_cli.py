"""Shared harness of the example-CLI parity tests: the JAX package's CLI
(``examples/<name>.py``) runs in this process through ``runpy`` with its
``sys.argv`` set, the port's through ``main(argv)`` on the CPU, both
printing into captured standard output. Test files import this after
``pytest.importorskip`` of JAX."""

import importlib.util
import os
import re
import runpy
import sys

import numpy as np

import gradslam_tpu.utils as jax_utils
from gradslam_tpu import ICPSLAM

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
COUNT_REL = 0.002  # map counts within 0.2%
FLOAT_ATOL = 1e-5  # printed metres (ATE) and poses within 1e-5
_NUMBER = re.compile(r"^-?\d+(\.\d+)?(e-?\d+)?$")


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# chip_smoke.py's tree writers and constants (it imports torch, never JAX)
cs = _load_chip_smoke()


def run_jax_example(name, argv, monkeypatch, capsys):
    """``examples/<name>.py argv`` in this process. Returns its standard
    output and the ``(pointclouds, poses)`` of each pipeline call it made.
    The JAX CLIs point XLA at a persistent compilation cache under the
    home directory; that call is made a no-op here."""
    calls = []
    real_call = ICPSLAM.__call__

    def recording_call(self, frames):
        out = real_call(self, frames)
        calls.append(out)
        return out

    monkeypatch.setattr(ICPSLAM, "__call__", recording_call)
    monkeypatch.setattr(jax_utils, "enable_compile_cache", lambda *a, **k: None)
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    capsys.readouterr()
    runpy.run_path(os.path.join(REPO, "examples", f"{name}.py"), run_name="__main__")
    return capsys.readouterr().out, calls


def run_port_example(module, argv, capsys):
    """``module.main(argv + ['--cpu'])``: its standard output and result."""
    capsys.readouterr()
    result = module.main([*argv, "--cpu"])
    return capsys.readouterr().out, result


def _tokens(text):
    return re.findall(r"[^\s\[\]\(\),:]+|[\[\]\(\),:]", text)


def assert_same_output(jax_out, port_out, replace=()):
    """The same lines, word for word, with numbers compared as numbers:
    integers (map counts) within ``COUNT_REL``, decimals within
    ``FLOAT_ATOL``. ``replace`` pairs are substituted in the JAX output
    first (its output directory for the port's)."""
    for a, b in replace:
        jax_out = jax_out.replace(a, b)
    jl, pl = jax_out.strip().splitlines(), port_out.strip().splitlines()
    assert len(jl) == len(pl), (jax_out, port_out)
    for jline, pline in zip(jl, pl):
        jt, pt = _tokens(jline), _tokens(pline)
        assert len(jt) == len(pt), (jline, pline)
        for a, b in zip(jt, pt):
            if _NUMBER.match(a) and _NUMBER.match(b):
                if "." in a or "e" in a:
                    assert abs(float(a) - float(b)) <= FLOAT_ATOL, (jline, pline)
                else:
                    assert abs(int(a) - int(b)) <= COUNT_REL * max(abs(int(a)), 1), (jline, pline)
            else:
                assert a == b, (jline, pline)


def assert_same_run(jax_run, torch_run):
    """A pipeline call's poses within ``FLOAT_ATOL`` and map counts within
    ``COUNT_REL``; maps of equal counts hold points within ``FLOAT_ATOL``
    of each other."""
    jpc, jposes = jax_run
    tpc, tposes = torch_run
    np.testing.assert_allclose(tposes.numpy(), np.asarray(jposes), atol=FLOAT_ATOL, rtol=0)
    jn, tn = np.asarray(jpc.num_points), tpc.num_points.numpy()
    assert np.all(np.abs(tn - jn) <= COUNT_REL * jn), (tn, jn)
    for b in range(len(jn)):
        if tn[b] == jn[b]:
            np.testing.assert_allclose(tpc.points_list[b], np.asarray(jpc.points_list[b]),
                                       atol=FLOAT_ATOL, rtol=0)


def online_state(out):
    """``(Pointclouds, poses)`` of ``out/state.npz`` on the CPU."""
    from gradslam_torch.utils.checkpoint import load_state

    pc, poses = load_state(f"{out}/state.npz", device="cpu")
    return pc, poses.numpy()


def check_online_cli(argv, tmp_path, monkeypatch, capsys):
    """The JAX and the port's ``online_slam`` CLI on ``argv`` (a size flag
    given twice: the last wins): the same output (output directories
    swapped), final poses within ``FLOAT_ATOL`` and map counts within
    ``COUNT_REL``, the trajectory files within ``FLOAT_ATOL``."""
    from gradslam_torch.examples import online_slam
    from gradslam_torch.utils.trajectory_io import load_trajectory_tum

    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_out, _ = run_jax_example("online_slam", [*argv, "--out", jax_dir], monkeypatch, capsys)
    port_out, (_, est) = run_port_example(online_slam, [*argv, "--out", port_dir], capsys)
    assert_same_output(jax_out, port_out, replace=[(jax_dir, port_dir)])
    if "--relocalize-below" in argv:
        assert "relocalized (inliers" in port_out
    (jpc, jposes), (tpc, tposes) = online_state(jax_dir), online_state(port_dir)
    np.testing.assert_allclose(tposes, jposes, atol=FLOAT_ATOL, rtol=0)
    np.testing.assert_array_equal(tposes, est.numpy())
    n_j, n_t = int(jpc.num_points[0]), int(tpc.num_points[0])
    assert abs(n_t - n_j) <= COUNT_REL * n_j
    for name in ("trajectory.txt", "groundtruth.txt"):
        _, jt = load_trajectory_tum(f"{jax_dir}/{name}")
        _, tt = load_trajectory_tum(f"{port_dir}/{name}")
        np.testing.assert_allclose(tt, jt, atol=FLOAT_ATOL, rtol=0)
    return port_out
