"""The port's in-scan tracking recovery (``ICPSLAM``/``PointFusion`` with
``relocalize_below`` and ``anchor_every``) held against the JAX package on
the CPU.

- The kidnapped clip of ``tests/slam/test_inscan_relocalize.py`` at 60x80x11
  (frames 0-7 pan, then the camera jumps back to frames 0-2), armed with the
  1-NN and with the projective tracker: poses within 1e-4 of JAX's, the
  gate's reading of each frame within 1/N of JAX's (read through a
  ``jax.debug.callback`` on JAX's ``_health_gate``), and the relocalization
  on the same frames; the post-kidnap error below 2 cm as in the JAX test.
- ``remat`` on against off on that clip, with gradients to the depth: the
  same SHA-256 digests of poses and map, and the same gradients (the
  recompute reads the same gate values, so takes the same branches).
- The anchor's drift branch against JAX on a short hard clip with
  ``anchor_below=1.0``, so that it runs on most frames: poses within 1e-4,
  the same refreshes and re-solves.
- Armed on an easy clip where nothing trips: the unarmed run's bits.
- The committed goldens hold the keys and shapes ``chip_smoke.py`` reads.
"""

import hashlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import gradslam_tpu as G  # noqa: E402
import gradslam_torch as T  # noqa: E402
from gradslam_tpu.slam.icpslam import ICPSLAM as JaxICPSLAM  # noqa: E402

from ._parity import both_frames  # noqa: E402

TUNED = dict(robust_loss="tukey", robust_scale=0.03, dist_thresh=0.01)
B, H, W = 1, 60, 80
ORDER = [0, 1, 2, 3, 4, 5, 6, 7, 0, 1, 2]
L = len(ORDER)


from ._threads import one_thread  # noqa: E402,F401


@pytest.fixture(scope="module")
def kidnapped():
    rgb, d, K, poses = T.synthetic_sequence(B, 12, H, W, speed=8.0)
    jump = tuple(float(x) for x in poses[0, 0, :3, 3] - poses[0, 7, :3, 3])
    arrays = (rgb[:, ORDER], d[:, ORDER], K, poses[:, ORDER])
    return arrays, jump


def rows(jump):
    zero = (0.0, 0.0, 0.0)
    return {
        "knn": dict(relocalize_below=0.5, relocalize_grid=dict(
            yaw_deg=(0.0,), translations=(zero, jump, tuple(-x for x in jump)))),
        "projective": dict(odom_assoc="projective", odom_angle_gate=60.0, relocalize_below=0.5,
                           relocalize_grid=dict(yaw_deg=(0.0,), translations=(zero, jump))),
    }


def jax_run(monkeypatch, arrays, kw):
    """JAX's run and its gate's reading of each tracked frame."""
    readings = []
    gate = JaxICPSLAM._health_gate

    def recorded(self, live, poses, window):
        inlier = gate(self, live, poses, window)
        jax.debug.callback(lambda x: readings.append(np.asarray(x)), inlier, ordered=True)
        return inlier

    monkeypatch.setattr(JaxICPSLAM, "_health_gate", recorded)
    jf, _ = both_frames(*arrays)
    pc, poses = G.PointFusion(**kw)(jf)
    return pc, np.asarray(poses), np.asarray(readings).reshape(len(readings), -1)


def post_kidnap_m(poses, gt):
    err = poses[0, 8:, :3, 3] - gt[0, 8:, :3, 3]
    return float(np.sqrt((err ** 2).sum(-1).mean()))


@pytest.mark.parametrize("name", ["knn", "projective"])
def test_kidnap_recovered_like_jax(monkeypatch, kidnapped, name):
    arrays, jump = kidnapped
    kw = dict(odom="gradicp", dsratio=4, numiters=10, map_capacity=L * H * W, **TUNED,
              **rows(jump)[name])
    jpc, jposes, readings = jax_run(monkeypatch, arrays, kw)
    _, tf = both_frames(*arrays)
    slam = T.PointFusion(**kw)
    tpc, tposes = slam(tf)
    np.testing.assert_allclose(tposes.numpy(), jposes, atol=1e-4, rtol=0)
    ours = torch.stack(slam.recovery_log["health"]).numpy()
    assert ours.shape == readings.shape == (L - 1, B)
    np.testing.assert_allclose(ours, readings, atol=1.0 / 300 + 1e-7, rtol=0)
    jax_frames = [f + 1 for f in range(L - 1) if (readings[f] < 0.5).any()]
    assert slam.recovery_log["relocalize"] == jax_frames == [8]
    assert slam.recovery_log["anchor"] == []
    assert post_kidnap_m(tposes.numpy(), arrays[3]) < 0.02
    assert abs(int(tpc.num_points[0]) - int(jpc.num_points[0])) <= 0.002 * int(jpc.num_points[0])


def _digest(pc, poses):
    h = hashlib.sha256()
    for t in (poses, pc.points, pc.normals, pc.num_points):
        h.update(t.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def test_remat_takes_the_same_branches(kidnapped):
    """The projective tracker armed on the kidnap (cut after the kidnapped
    frame, five iterations a solve): its relocalization runs the
    hypotheses' 1-NN solves inside the checkpointed frame."""
    arrays, jump = kidnapped
    rgb, depth, K, P = arrays
    arrays = (rgb[:, :9], depth[:, :9], K, P[:, :9])
    kw = dict(odom="gradicp", dsratio=4, numiters=5, map_capacity=9 * H * W, **TUNED,
              **rows(jump)["projective"])
    out = {}
    for remat in (False, True):
        rgb, depth, K, P = (torch.from_numpy(np.array(a)) for a in arrays)
        depth.requires_grad_()
        slam = T.PointFusion(remat=remat, **kw)
        pc, poses = slam(T.RGBDImages(rgb, depth, K, P))
        ((pc.points ** 2).sum() + (poses[..., :3, 3] ** 2).sum()).backward()
        out[remat] = (_digest(pc, poses), depth.grad, slam.recovery_log["relocalize"])
    assert out[False][0] == out[True][0]
    assert out[False][2] == out[True][2] == [8]
    assert bool(torch.isfinite(out[True][1]).all())
    assert torch.equal(out[False][1], out[True][1])


def test_anchor_branch_matches_jax():
    """The drift branch run on most frames (``anchor_below=1.0``: any
    anchor row off the band is drift), with refreshes every 3 frames, on a
    short noisy clip: the same poses as JAX within 1e-4."""
    rgb, d, K, poses = T.hard_sequence(1, 7, H, W, outlier_frac=0.0)
    jf, tf = both_frames(rgb, d, K, poses)
    kw = dict(odom="gradicp", odom_assoc="projective", dsratio=4, numiters=6,
              motion_model="constant_velocity", odom_angle_gate=60.0, map_capacity=7 * H * W,
              relocalize_below=0.2, anchor_every=3, anchor_below=1.0, **TUNED)
    _, jposes = G.PointFusion(**kw)(jf)
    slam = T.PointFusion(**kw)
    _, tposes = slam(tf)
    assert len(slam.recovery_log["anchor"]) >= 3
    np.testing.assert_allclose(tposes.numpy(), np.asarray(jposes), atol=1e-4, rtol=0)


HEALTHY = dict(odom="gradicp", odom_assoc="projective", odom_sym_normals=True, dsratio=2,
               numiters=8, map_capacity=8 * H * W)


@pytest.fixture(scope="module")
def healthy():
    """The clean clip's frames and the unarmed run's digest, made once for
    both armed cases."""
    rgb, d, K, poses = T.synthetic_sequence(1, 8, H, W)
    _, tf = both_frames(rgb, d, K, poses)
    return tf, _digest(*T.PointFusion(**HEALTHY)(tf))


@pytest.mark.parametrize("armed", [
    dict(relocalize_below=0.2),
    dict(relocalize_below=0.2, anchor_every=3),
], ids=["relocalize", "relocalize_anchor"])
def test_armed_healthy_run_is_the_unarmed_run(healthy, armed):
    """On a clean clip nothing trips: the armed run's poses and map are the
    unarmed run's bits (the branches never ran)."""
    tf, base = healthy
    slam = T.PointFusion(**HEALTHY, **armed)
    assert _digest(*slam(tf)) == base
    assert slam.recovery_log["relocalize"] == slam.recovery_log["anchor"] == []
    assert len(slam.recovery_log["health"]) == 7


def _chip_smoke():
    import importlib.util
    import os

    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(root, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("golden", ["recovery", "large_map"])
def test_goldens_hold_what_chip_smoke_reads(golden):
    """The committed JAX CPU goldens carry, for every row of
    ``chip_smoke.py``, the keys and shapes its recovery phase reads, and
    were made from its clips (the kidnap's jump)."""
    cs = _chip_smoke()
    data = np.load(cs.RECOVERY_GOLDEN if golden == "recovery" else cs.LARGE_GOLDEN)
    scalars = ("num_points", "num_dropped", "ate_m", "ate_unaligned_m")
    if golden == "large_map":
        rows = {name: cs.LARGE_SHAPE[1] for name in cs.LARGE_ROWS}
    else:
        _, _, _, _, jump = cs.kidnap_clip()
        np.testing.assert_array_equal(data["kidnap_jump"], np.asarray(jump))
        Lk = len(cs.KIDNAP_ORDER)
        rows = {f"kidnap_{n}": Lk for n in cs.kidnap_rows(jump)}
        rows.update({f"drift_{n}": cs.DRIFT_SHAPE[1] for n in cs.DRIFT_ROWS})
        rows.update({f"subpixel_{n}": cs.L for n in cs.SUBPIXEL_ROWS})
        rows["hard_subpixel"] = cs.L
        for name, row in cs.kidnap_rows(jump).items():
            health = data[f"kidnap_{name}_health"]
            assert health.shape == ((Lk - 1,) if row.get("relocalize_below") else (0,))
            drift = data[f"kidnap_{name}_drift"]
            assert drift.dtype == bool
            assert drift.shape == ((Lk - 1,) if row.get("anchor_every") else (0,))
            assert data[f"kidnap_{name}_post_ate_m"].shape == ()
    for row, length in rows.items():
        assert data[f"{row}_poses"].shape == (length, 4, 4)
        assert np.isfinite(data[f"{row}_poses"]).all()
        for key in scalars:
            assert data[f"{row}_{key}"].shape == ()
        assert int(data[f"{row}_num_dropped"]) == 0
