"""The port's ``DataParallelSLAM`` and the sharding helpers on
``torch.distributed`` (gloo, CPU, a spawned world of 2) against the JAX
package's ``tests/parallel/test_sharding.py`` cases at their sizes (B = 8,
16x24x2) and against the port's single-process pipelines.

Every rank passes the whole batch, runs its block and gets back the whole
batch's maps and poses. The gradient of a loss over the gathered batch
reaches each rank's own block of the depths and intrinsics; the blocks
together are held to ``jax.grad`` of the same loss and to the port's
single-process gradient within 1e-4 of the largest
(``tests/port/_gradparity.py``'s bar)."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from gradslam_torch import ICPSLAM, PointFusion  # noqa: E402
from gradslam_tpu import PointFusion as JaxPointFusion  # noqa: E402
from gradslam_tpu import RGBDImages as JaxRGBDImages  # noqa: E402

from . import _parallel_cases as C  # noqa: E402
from . import _parallel_worlds as worlds  # noqa: E402


def _jax_frames(depth=None, intrinsics=None, features=False):
    rgb, d, K, poses = worlds.frames_np(**C.B8)
    frames = JaxRGBDImages(jnp.asarray(rgb), d if depth is None else depth,
                           jnp.asarray(K) if intrinsics is None else intrinsics,
                           jnp.asarray(poses))
    if features:
        import dataclasses

        frames = dataclasses.replace(frames, feature_image=jnp.asarray(
            worlds.labels_np(*rgb.shape[:4])))
    return frames


def _jax_grads():
    """``jax.grad`` of ``sum(points ** 2)`` to depth and intrinsics."""
    _, depth, K, _ = worlds.frames_np(**C.B8)
    slam = JaxPointFusion(odom="gt", use_jit=False)

    def loss_fn(d, k):
        pc, _ = slam.forward(_jax_frames(d, k))
        return jnp.sum(pc.points ** 2)

    g = jax.jit(jax.grad(loss_fn, argnums=(0, 1)))(jnp.asarray(depth), jnp.asarray(K))
    return [np.asarray(x) for x in g]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    join = worlds.spawn_world(2, tmp_path_factory.mktemp("sharding_world"),
                              "tests.port._parallel_cases", "SHARDING")
    refs = {"grads": _jax_grads()}
    pc, poses = JaxPointFusion(odom="gt")(_jax_frames())
    refs["forward"] = (np.asarray(pc.points), np.asarray(pc.num_points), np.asarray(poses))
    pc, _ = JaxPointFusion(odom="gt", feature_channels=2)(_jax_frames(features=True))
    refs["features"] = np.asarray(pc.features)
    return join(), refs


def _both(world, case, key):
    """Rank 0's result, after checking rank 1 returned the same."""
    a, b = (worlds.value(world[0], case, key, r) for r in (0, 1))
    np.testing.assert_array_equal(a, b)
    return a


def test_sharded_forward_matches_single_device(world):
    """Both ranks get the whole batch's map and poses: equal to the port's
    single-process run bit for bit and to JAX's within its test's bars."""
    pc_s, poses_s = PointFusion(odom="gt")(C.frames_for(C.B8))
    points = _both(world, "forward", "points")
    np.testing.assert_array_equal(points, pc_s.points.numpy())
    np.testing.assert_array_equal(_both(world, "forward", "num_points"),
                                  pc_s.num_points.numpy())
    np.testing.assert_array_equal(_both(world, "forward", "poses"), poses_s.numpy())
    j_points, j_num, j_poses = world[1]["forward"]
    np.testing.assert_array_equal(_both(world, "forward", "num_points"), j_num)
    np.testing.assert_allclose(points, j_points, atol=1e-5)
    np.testing.assert_allclose(_both(world, "forward", "poses"), j_poses, atol=1e-6)


def test_feature_plane_shards_with_the_batch(world):
    pc_s, _ = PointFusion(odom="gt", feature_channels=2)(C.frames_for(dict(C.B8,
                                                                          features=True)))
    features = _both(world, "features", "features")
    np.testing.assert_array_equal(features, pc_s.features.numpy())
    np.testing.assert_allclose(features, world[1]["features"], atol=1e-6)


def test_indivisible_batch_raises(world):
    res = world[0][0]["indivisible"]
    assert "ValueError" in str(res["error"])
    assert "Batch size (3) must be divisible by the mesh size (2)" in str(res["error"])


def test_placements_and_blocks(world):
    """``batch_sharding`` and ``map_sharded_spec`` are the ``Shard(0)`` and
    ``Shard(1)`` placements; ``shard_frames`` and ``shard_pointclouds``
    return each rank's contiguous block."""
    assert "Shard(dim=0)" in str(_both(world, "placements", "batch"))
    assert "Shard(dim=1)" in str(_both(world, "placements", "map"))
    _, depth, _, _ = worlds.frames_np(**C.B8)
    for r in (0, 1):
        np.testing.assert_array_equal(worlds.value(world[0], "placements", "depth", r),
                                      depth[4 * r:4 * r + 4])
        np.testing.assert_array_equal(worlds.value(world[0], "placements", "num_points", r),
                                      np.arange(4 * r, 4 * r + 4))


def test_sharded_grad_step(world):
    """Each rank's gradient is nonzero in its own block only; the blocks
    together equal the single-process gradient and ``jax.grad`` within 1e-4
    of the largest, finite, and not all zero."""
    rgb, depth, K, poses = worlds.frames_np(**C.B8)
    d_t = torch.from_numpy(depth).requires_grad_(True)
    k_t = torch.from_numpy(K).requires_grad_(True)
    frames = C.frames_for(C.B8)
    frames = frames.__class__(rgb_image=frames.rgb_image, depth_image=d_t, intrinsics=k_t,
                              poses=frames.poses)
    pc, _ = PointFusion(odom="gt")(frames)
    loss = torch.sum(pc.points ** 2)
    loss.backward()
    for key, single, jax_g in (("g_depth", d_t.grad.numpy(), world[1]["grads"][0]),
                               ("g_intr", k_t.grad.numpy(), world[1]["grads"][1])):
        blocks = [worlds.value(world[0], "grad", key, r) for r in (0, 1)]
        for r, g in enumerate(blocks):
            other = slice(4, 8) if r == 0 else slice(0, 4)
            assert not g[other].any()
        g = blocks[0] + blocks[1]
        assert np.all(np.isfinite(g)) and np.abs(g).max() > 0
        scale = np.abs(jax_g).max()
        assert np.abs(g - single).max() <= 1e-4 * np.abs(single).max()
        assert np.abs(g - jax_g).max() <= 1e-4 * scale
    assert float(_both(world, "grad", "loss")) == pytest.approx(float(loss.detach()), rel=1e-6)


def test_gradicp_pipeline_shards(world):
    pc_s, poses_s = PointFusion(odom="gradicp", dsratio=2, numiters=2, map_capacity=1024)(
        C.frames_for(C.B8))
    poses = _both(world, "tracked", "poses")
    assert poses.shape == (8, 2, 4, 4) and np.all(np.isfinite(poses))
    np.testing.assert_array_equal(poses, poses_s.numpy())
    np.testing.assert_array_equal(_both(world, "tracked", "points"), pc_s.points.numpy())


def test_step_with_cv_prior_shards(world):
    """``step`` with the constant-velocity prior split over the ranks equals
    the single-process steps."""
    frames = C.frames_for(C.B8)
    slam = ICPSLAM(odom="icp", dsratio=2, numiters=2)
    pc = slam.empty_map(8, 2 * 16 * 24, device="cpu")
    pc, pose = slam.step(pc, frames[:, 0])
    prev = frames[:, 0].with_poses(pose)
    pc, pose2 = slam.step(pc, frames[:, 1], prev, prev_transform=torch.eye(4).expand(8, 4, 4))
    np.testing.assert_array_equal(_both(world, "step", "pose"), pose.numpy())
    got = _both(world, "step", "pose2")
    assert got.shape == (8, 1, 4, 4) and np.all(np.isfinite(got))
    np.testing.assert_array_equal(got, pose2.numpy())
    np.testing.assert_array_equal(_both(world, "step", "points"), pc.points.numpy())
    np.testing.assert_array_equal(_both(world, "step", "num_points"), pc.num_points.numpy())


def test_make_mesh_without_a_process_group_raises():
    """The pytest process never initialises a group: ``make_mesh`` (and so
    ``DataParallelSLAM`` without a mesh) refuses, naming the call it
    needs."""
    import torch.distributed as dist

    from gradslam_torch.parallel import DataParallelSLAM, make_mesh

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_mesh()
    with pytest.raises(RuntimeError, match="init_process_group"):
        DataParallelSLAM(PointFusion(odom="gt"))
