"""The port's ``MapShardedPointFusion`` on ``torch.distributed`` (gloo, CPU)
against the JAX package's on a K-device sub-mesh of the conftest's 8 virtual
devices, and against the port's single-process ``PointFusion``: every case of
``tests/parallel/test_map_sharded.py`` at its sizes (16x24x3-5, 12x16x2).

One spawned world of 4 processes runs every case once
(``tests/port/_parallel_cases.py``: K = 4, the K = 2 map rows of a 2 x 2
mesh, and the 2 x 2 mesh with ``batch_axis``); the JAX references run in
this process meanwhile. ``use_jit``: the rows of ``C.MS_CAPTURED`` run
again with their frames replayed from CUDA graphs, the capture emulated on
the CPU, and are held bit for bit against ``use_jit=False`` (arrays,
launches, collective bytes and calls) and against JAX's jitted pipeline.

Tolerances: against JAX shard by shard (each rank's rows against the JAX
shard of the same index, since appends are dealt round-robin alike):
counters exact, rows within 1e-5 (gt) or 1e-4 (tracked), quantized colours
within one level. Against the single-process pipeline: the sorted point
set within 1e-5 (gt) or 1e-4 (tracked), counts equal, poses within 1e-4
(tracked), as the JAX tests bar them.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from gradslam_torch import PointFusion  # noqa: E402
from gradslam_torch.ops import nn_points  # noqa: E402
from gradslam_tpu import RGBDImages as JaxRGBDImages  # noqa: E402
from gradslam_tpu.ops.knn import nn_points as jax_nn_points  # noqa: E402
from gradslam_tpu.parallel import MapShardedPointFusion as JaxMapSharded  # noqa: E402
from gradslam_tpu.parallel import make_mesh as jax_make_mesh  # noqa: E402

from . import _parallel_cases as C  # noqa: E402
from . import _parallel_worlds as worlds  # noqa: E402

# each rank's (batch block, shard) on the meshes of the world
LAYOUT = {"mesh4": [[0, 1, 2, 3]], "mesh2": [[0, 1]], "mesh2d": [[0, 1], [2, 3]]}
JAX_CASES = ("gt_k4", "gt_k2", "prune_gt", "prune_tracked", "tracked", "quantized",
             "features", "overflow", "mesh2d_gt", "mesh2d_gradicp", "projective",
             "quantized_features")
TRACKED = {n for n, (_, _, kw) in C.MS_RUNS.items() if kw.get("odom", "gt") != "gt"}


def _jax_frames(spec):
    spec = dict(spec)
    feats, cf, no_poses = (spec.pop(k, False) for k in ("features", "channels_first",
                                                         "no_poses"))
    rgb, depth, K, poses = worlds.frames_np(**spec)
    frames = JaxRGBDImages(jnp.asarray(rgb), jnp.asarray(depth), jnp.asarray(K),
                           None if no_poses else jnp.asarray(poses))
    if feats:
        import dataclasses

        frames = dataclasses.replace(frames, feature_image=jnp.asarray(
            worlds.labels_np(*rgb.shape[:4])))
    return frames


def _jax_mesh(kind):
    from jax.sharding import Mesh

    if kind == "mesh2d":
        return Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("dp", "map"))
    return jax_make_mesh(jax.devices()[:4 if kind == "mesh4" else 2], axis_name="map")


def _jax_run(name):
    mesh, spec, kw = C.MS_RUNS[name]
    smap, poses = JaxMapSharded(mesh=_jax_mesh(mesh), **kw)(_jax_frames(spec))
    return {k: np.asarray(v) for k, v in smap._asdict().items()} | {"poses": np.asarray(poses)}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    join = worlds.spawn_world(4, tmp_path_factory.mktemp("map_sharded_world"),
                              "tests.port._parallel_cases", "MAP_SHARDED")
    refs = {name: _jax_run(name) for name in JAX_CASES}  # while the world runs
    return join(), refs


def _port(world, name):
    return lambda key, rank=0: worlds.value(world[0], name, key, rank)


def _assembled(world, name, key, case=None):
    """The whole ``(B, CAP, c)`` buffer from the ranks' shards (of the
    world's ``case``, by default the row's own)."""
    rows = LAYOUT[C.MS_RUNS[name][0]]
    return np.concatenate([np.concatenate([worlds.value(world[0], case or name, key, r)
                                           for r in row], axis=1) for row in rows], axis=0)


def _sorted_rows(x):
    x = np.asarray(x)
    return x[np.lexsort((x[:, 2], x[:, 1], x[:, 0]))]


def _single(name):
    """The port's single-process PointFusion on the case's frames."""
    _, spec, kw = C.MS_RUNS[name]
    kw = {"odom": "gt", **{k: v for k, v in kw.items() if k != "batch_axis"}}
    return PointFusion(**kw)(C.frames_for(spec))


def _hold_to_jax(world, name, case=None, prefix=""):
    """Each rank's rows (the world's ``case``, keys ``prefix + field``)
    against the JAX shard of the same index: counters exact, rows within
    1e-5 (gt) or 1e-4 (tracked), poses likewise; packed colours within one
    level."""
    ref = world[1][name]
    case = case or name
    port = _port(world, case)
    np.testing.assert_array_equal(port(prefix + "num_points"), ref["num_points"])
    np.testing.assert_array_equal(port(prefix + "num_dropped"), ref["num_dropped"])
    tol = 1e-4 if name in TRACKED else 1e-5
    np.testing.assert_allclose(port(prefix + "poses"), ref["poses"], atol=tol)
    for key in ("points", "normals", "features"):
        got = _assembled(world, name, prefix + key, case)
        assert got.shape == ref[key].shape
        np.testing.assert_allclose(got, ref[key], atol=tol, err_msg=key)
    got = _assembled(world, name, prefix + "colors", case)
    if ref["colors"].shape[-1] == 1:  # packed
        from gradslam_torch.slam.fusionutils import unpack_colors

        assert got.shape[-1] == 1
        got = unpack_colors(torch.tensor(got)).numpy()
        want = unpack_colors(torch.tensor(ref["colors"])).numpy()
        assert np.abs(got - want).max() <= 1.0 / 255 + 1e-6
    else:
        np.testing.assert_allclose(got, ref["colors"], atol=tol)


@pytest.mark.parametrize("name", JAX_CASES)
def test_shard_by_shard_equals_jax(world, name):
    """Each rank's rows equal the JAX shard of the same index: counters
    exact, rows within 1e-5 (gt) or 1e-4 (tracked), poses likewise."""
    _hold_to_jax(world, name)


@pytest.mark.parametrize("name", C.MS_CAPTURED)
def test_captured_gives_the_eager_bits(world, name):
    """The row with its frames replayed from CUDA graphs (the capture
    emulated under gloo, K = 2) against ``use_jit=False`` in the same
    world, on every rank: the first and the second call bit-equal to
    eager, with equal launch counts (counted at the dispatchers) and
    equal collective bytes and calls by tag; the first result, as the
    caller held it, unchanged by the second call; one graph for the
    pipeline's one key, replayed."""
    import json

    case = f"captured_{name}"
    key = "fuse" if C.MS_RUNS[name][2].get("odom", "gt") == "gt" else "track"
    for rank in range(4):
        port = _port(world, case)
        for call in ("first", "second", "held"):
            for field in C.MS_FIELDS:
                np.testing.assert_array_equal(port(f"{call}_{field}", rank),
                                              port(f"eager_{field}", rank),
                                              err_msg=f"{call} {field}, rank {rank}")
        counts = {c: json.loads(str(port(f"{c}_counts", rank))) for c in ("eager", "first",
                                                                         "second")}
        assert counts["first"] == counts["eager"] == counts["second"], counts
        assert counts["eager"]["bytes_fusion"] > 0 and counts["eager"]["scatter"] > 0
        assert port("first_captured", rank) and port("second_captured", rank)
        assert int(port("graphs", rank)) == 1 and list(port("keys", rank)) == [key]
        assert int(port("replays", rank)) > 0


@pytest.mark.parametrize("name", C.MS_CAPTURED)
def test_captured_shard_by_shard_equals_jax(world, name):
    """The replayed (second) call of each captured row against the JAX
    package's jitted ``MapShardedPointFusion`` on a 2-device virtual CPU
    mesh, at ``test_shard_by_shard_equals_jax``'s tolerances."""
    _hold_to_jax(world, name, f"captured_{name}", "second_")


def test_a_failed_sharded_capture_raises_and_stores_nothing(world):
    for rank in range(4):
        res = _port(world, "failed_capture")
        assert "capture of the 'fuse' frame body" in str(res("raised", rank))
        assert int(res("graphs", rank)) == 0


@pytest.mark.parametrize("name", sorted(n for n, v in C.MS_RUNS.items() if v[0] == "mesh2"))
def test_both_k2_rows_agree(world, name):
    """Ranks 0-1 and 2-3 each ran the K = 2 case as a map row of their own:
    the same inputs give bit-equal shards."""
    for key in ("points", "normals", "colors", "features", "num_points", "poses"):
        for a, b in ((0, 2), (1, 3)):
            np.testing.assert_array_equal(worlds.value(world[0], name, key, a),
                                          worlds.value(world[0], name, key, b))


@pytest.mark.parametrize("name", sorted(n for n in C.MS_RUNS if n not in ("overflow",)))
def test_matches_single_process_pointfusion(world, name):
    """The sharded map's point set, count and confidence mass equal the
    port's single-process PointFusion (the JAX tests' bars), poses within
    1e-5 (gt and the 2-D mesh) or 1e-4 (tracked)."""
    port = _port(world, name)
    pc_s, poses_s = _single(name)
    tol = 1e-4 if name in TRACKED else 1e-5
    np.testing.assert_allclose(port("poses"), poses_s.numpy(), atol=tol)
    np.testing.assert_array_equal(port("num_points").sum(axis=0), pc_s.num_points.numpy())
    np.testing.assert_array_equal(port("pc_num_points"), pc_s.num_points.numpy())
    for b in range(len(pc_s)):
        n = int(pc_s.num_points[b])
        np.testing.assert_allclose(_sorted_rows(port("pc_points")[b, :n]),
                                   _sorted_rows(pc_s.points[b, :n].numpy()), atol=tol)
        np.testing.assert_allclose(port("pc_features")[b, :n, 0].sum(),
                                   pc_s.features[b, :n, 0].sum().item(), rtol=1e-5)


def test_prune_removed_rows(world):
    noprune = PointFusion(odom="gt", map_capacity=4 * 512)(C.frames_for(C.MS_RUNS["prune_gt"][1]))
    n = int(_port(world, "prune_gt")("num_points").sum())
    assert 0 < n < int(noprune[0].num_points.sum())


def test_quantized_export_unpacks_after_compaction(world):
    """The packed slice is 1 wide; ``to_pointclouds`` unpacks it to float
    colours within one level of the float pipeline's, per matched point."""
    port = _port(world, "quantized")
    assert port("colors").shape[-1] == 1 and port("pc_colors").shape[-1] == 3
    pc_s, _ = PointFusion(odom="gt", map_capacity=4 * 512)(C.frames_for(C.L3))
    n = int(pc_s.num_points[0])
    pm, ps = port("pc_points")[0, :n], pc_s.points[0, :n].numpy()
    om = np.lexsort((pm[:, 2], pm[:, 1], pm[:, 0]))
    os_ = np.lexsort((ps[:, 2], ps[:, 1], ps[:, 0]))
    np.testing.assert_allclose(port("pc_colors")[0, :n][om], pc_s.colors[0, :n].numpy()[os_],
                               atol=0.02)


def test_features_fuse_per_point(world):
    port = _port(world, "features")
    assert port("features").shape[-1] == 3  # [ccount, 2 user]
    pc_s, _ = _single("features")
    n = int(pc_s.num_points[0])
    pm, ps = port("pc_points")[0, :n], pc_s.points[0, :n].numpy()
    om = np.lexsort((pm[:, 2], pm[:, 1], pm[:, 0]))
    os_ = np.lexsort((ps[:, 2], ps[:, 1], ps[:, 0]))
    np.testing.assert_allclose(port("pc_features")[0, :n][om],
                               pc_s.features[0, :n].numpy()[os_], atol=1e-4)


def test_overflow_accounting(world):
    """A too-small capacity surfaces in ``num_dropped`` (and in the exported
    cloud's), a roomy one drops nothing."""
    port = _port(world, "overflow")
    assert port("num_dropped").sum() > 0 and port("pc_num_dropped").sum() > 0
    assert (port("num_points") == 16).all()
    assert _port(world, "roomy")("num_dropped").sum() == 0


def test_channels_first_matches_channels_last(world):
    a, b = _port(world, "roomy"), _port(world, "channels_first")
    np.testing.assert_array_equal(a("poses"), b("poses"))
    for rank in range(4):
        np.testing.assert_array_equal(a("points", rank), b("points", rank))


def test_normal_pitch_changes_the_normals(world):
    a, b = _port(world, "normal_pitch"), _port(world, "pitch1")
    assert not np.allclose(a("normals"), b("normals"))


@pytest.mark.parametrize("name", sorted(C.MS_ERRORS))
def test_validation_errors(world, name):
    """JAX's refusals, with its messages."""
    res = world[0][0][name]
    assert "error" in res, f"{name} did not raise"
    assert "ValueError" in str(res["error"]) and C.MS_ERRORS[name][3] in str(res["error"])


def test_collective_volume(world):
    """The fusion traffic is frame-sized and capacity-independent: one
    winner table of 3 x 4 bytes a pixel, gathered from K shards, a fused
    frame: 3 * K * B * H*W * 4 bytes, at 1,024 and 8,192 rows alike.
    Projective odometry gathers no window, and its normal equations take at
    most 512 bytes an iteration (AtA, Atb and the two error sums: 176)."""
    port = _port(world, "volume")
    L, K, B, HW = 2, 4, 1, 16 * 24
    np.testing.assert_array_equal(port("small_fusion"), [L * 3 * K * B * HW * 4, L])
    np.testing.assert_array_equal(port("big_fusion"), port("small_fusion"))
    assert port("small_window")[0] == port("proj_window")[0] == 0
    np.testing.assert_array_equal(port("proj_fusion"), port("small_fusion"))
    iters = (L - 1) * 2
    assert port("proj_normal_eq")[0] == iters * 176 <= iters * 512
    assert port("proj_normal_eq")[1] == 2 * iters


def test_window_traffic_is_the_gathered_windows(world):
    """The 1-NN path gathers each level's window (6 floats a row) and its
    counts: K * (win * 24 + 8) bytes a sequence, level and tracked frame."""
    port = _port(world, "tracked")
    K, win = 2, 2 * 8 * 12
    assert port("bytes_window") == 2 * K * (win * 24 + 8)


def test_sharded_knn_matches_single_device(world):
    rng = np.random.RandomState(0)
    src = rng.randn(100, 3).astype(np.float32)
    tgt = rng.randn(4 * 50, 3).astype(np.float32)
    mask = rng.rand(4 * 50) < 0.8
    d_ref, i_ref = jax_nn_points(jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(mask))
    d_t, i_t = nn_points(torch.from_numpy(src), torch.from_numpy(tgt), torch.from_numpy(mask))
    for rank in range(4):
        port = _port(world, "knn")
        np.testing.assert_array_equal(port("idx", rank), np.asarray(i_ref))
        np.testing.assert_array_equal(port("idx", rank), i_t.numpy())
        np.testing.assert_allclose(port("dist", rank), np.asarray(d_ref), atol=1e-5)


def test_use_jit_accepted_and_ignored(world):
    """``use_jit`` is honoured: on the card (or under the emulated capture,
    ``test_captured_gives_the_eager_bits``) the frames replay CUDA graphs;
    on CPU tensors the run is eager and says why."""
    port = _port(world, "use_jit")
    assert int(port("K")) == 4
    assert str(port("reason_True")) == "inputs not on the card"
    assert str(port("reason_False")) == "use_jit=False"
    for flag in (True, False):
        assert not port(f"captured_{flag}") and int(port(f"graphs_{flag}")) == 0


def test_no_process_group_raises_naming_init():
    from gradslam_torch.parallel import MapShardedPointFusion, make_mesh

    with pytest.raises(RuntimeError, match="init_process_group"):
        make_mesh()
    with pytest.raises(RuntimeError, match="init_process_group"):
        MapShardedPointFusion(map_capacity=64)
    with pytest.raises(ValueError, match="odom_assoc"):  # checked before the mesh
        MapShardedPointFusion(map_capacity=64, odom_assoc="nearest")


def _chip_smoke():
    import importlib.util
    import os

    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(root, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_sharded_golden_holds_what_chip_smoke_reads():
    """The committed JAX CPU golden (``tests/port/make_sharded_golden.py``)
    carries, for every row of ``chip_smoke.SHARDED_ROWS``, the keys and
    shapes the sharded phase reads, and was made from its rows: the clip's
    shape, the mesh size and each row's constructor arguments."""
    import json

    cs = _chip_smoke()
    data = np.load(cs.SHARDED_GOLDEN)
    assert tuple(data["shape"]) == (1, cs.L, cs.H, cs.W)
    K = int(data["k"])
    assert K == cs.SHARDED_GOLDEN_K
    for name, row in cs.SHARDED_ROWS.items():
        want = dict(row, map_capacity=cs.SHARDED_CAP)
        assert json.loads(str(data[f"{name}_config"])) == want
        assert data[f"{name}_poses"].shape == (cs.L, 4, 4)
        assert np.isfinite(data[f"{name}_poses"]).all()
        counts = data[f"{name}_shard_counts"]
        assert counts.shape == (K,) and int(counts.sum()) == int(data[f"{name}_num_points"])
        assert int(data[f"{name}_num_dropped"]) == 0
        for key in ("mass", "ate_m"):
            assert data[f"{name}_{key}"].shape == () and np.isfinite(data[f"{name}_{key}"])
        # appends are dealt round-robin: the shards stay balanced
        assert counts.max() - counts.min() <= 0.001 * counts.mean()
