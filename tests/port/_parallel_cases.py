"""The cases the spawned gloo worlds run (``tests/port/_parallel_worlds.py``).
Each child imports torch and the port only, never JAX. Each case returns
this rank's numpy results; the test modules hold them against the JAX
package and the port's single-process runs.

``MAP_SHARDED`` runs in a world of 4: ``mesh4`` (1-D, K = 4), ``mesh2d``
(2 x 2, ``('dp', 'map')``) and ``mesh2``, the K = 2 map row of ``mesh2d``
that holds this rank (ranks 0-1 and 2-3 each run the K = 2 cases, the same
inputs giving the same results). Its ``captured_<row>`` cases run the
``MS_CAPTURED`` rows again with the CUDA-graph capture emulated
(``tests/port/_graph_emulation.py``), beside ``use_jit=False``.
``SHARDING`` runs in a world of 2.
"""

import numpy as np

from ._parallel_worlds import frames_np, labels_np, torch_frames

# --------------------------------------------------------------------------- #
# MapShardedPointFusion (world of 4)
# --------------------------------------------------------------------------- #

L3 = dict(B=1, L=3, H=16, W=24)
# name -> (mesh, frames, constructor arguments); every one is held against
# the port's single-process PointFusion or the JAX package by the parent
MS_RUNS = {
    "gt_k4": ("mesh4", L3, dict(map_capacity=4 * 256)),
    "gt_k2": ("mesh2", L3, dict(map_capacity=2 * 512)),
    "prune_gt": ("mesh4", dict(L3, L=5), dict(map_capacity=4 * 512, prune_every=2,
                                               prune_min_confidence=0.05)),
    "prune_tracked": ("mesh2", dict(L3, L=5), dict(
        map_capacity=2 * 1024, odom="gradicp", dsratio=2, numiters=4, prune_every=2,
        prune_min_confidence=0.05)),
    "batched": ("mesh4", dict(B=2, L=2, H=12, W=16, seed=3), dict(map_capacity=4 * 128)),
    "tracked": ("mesh2", L3, dict(map_capacity=2 * 1024, odom="gradicp", dsratio=2,
                                  numiters=6)),
    "tracked_cv": ("mesh2", L3, dict(map_capacity=2 * 1024, odom="gradicp", dsratio=2,
                                     numiters=6, motion_model="constant_velocity")),
    "pyramid": ("mesh2", L3, dict(map_capacity=2 * 1024, odom="gradicp",
                                  pyramid=[(4, 4), (2, 3)])),
    "robust": ("mesh2", L3, dict(map_capacity=2 * 1024, odom="icp", dsratio=2, numiters=4,
                                 robust_loss="huber", robust_scale=0.05)),
    "quantized": ("mesh4", L3, dict(map_capacity=4 * 512, quantize_colors=True)),
    "features": ("mesh4", dict(L3, features=True), dict(map_capacity=4 * 512,
                                                        feature_channels=2)),
    "overflow": ("mesh4", L3, dict(map_capacity=4 * 16)),
    "roomy": ("mesh4", L3, dict(map_capacity=4 * 256)),
    "channels_first": ("mesh4", dict(L3, channels_first=True), dict(map_capacity=4 * 256)),
    "mesh2d_gt": ("mesh2d", dict(L3, B=2), dict(map_capacity=2 * 512, batch_axis="dp")),
    "mesh2d_gradicp": ("mesh2d", dict(L3, B=2), dict(map_capacity=2 * 512, batch_axis="dp",
                                                     odom="gradicp", dsratio=2, numiters=4)),
    "normal_pitch": ("mesh2", L3, dict(map_capacity=2 * 1024, odom="icp", dsratio=2,
                                       numiters=4, normal_pitch=2)),
    "pitch1": ("mesh2", L3, dict(map_capacity=2 * 1024, odom="icp", dsratio=2, numiters=4)),
    "projective": ("mesh2", L3, dict(map_capacity=2 * 1024, odom="gradicp",
                                     odom_assoc="projective", dsratio=2, numiters=6)),
    "proj_gate_pyramid": ("mesh2", L3, dict(
        map_capacity=2 * 1024, odom="gradicp", odom_assoc="projective", odom_angle_gate=60.0,
        pyramid=[(4, 4), (2, 3)])),
    "proj_sym": ("mesh2", L3, dict(map_capacity=2 * 1024, odom="gradicp",
                                   odom_assoc="projective", odom_sym_normals=True, dsratio=2,
                                   numiters=6)),
    "proj_subpixel_reuse": ("mesh2", L3, dict(
        map_capacity=2 * 1024, odom="icp", odom_assoc="projective", odom_subpixel=True,
        lookahead_assoc="reuse", dist_thresh=0.05, robust_loss="tukey", dsratio=2,
        numiters=4)),
    "hybrid": ("mesh2", L3, dict(map_capacity=2 * 1024, odom="gradicp",
                                 pyramid=[(4, 4), (2, 3)], odom_assoc=["projective", "knn"],
                                 odom_sym_normals=True)),
    "knn_gate": ("mesh2", L3, dict(map_capacity=2 * 1024, odom="gradicp", odom_assoc="knn",
                                   odom_angle_gate=75.0, dsratio=2, numiters=6)),
    "quantized_features": ("mesh2", dict(L3, features=True), dict(
        map_capacity=2 * 512, quantize_colors=True, feature_channels=2)),
}

# the rows run again with the capture emulated (``tests/port/_graph_emulation.py``)
# as ``captured_<row>``: gt, the 1-NN and the projective tracker, a prune
# and the quantized layout with features, at K = 2
MS_CAPTURED = ("gt_k2", "tracked", "projective", "prune_tracked", "quantized_features")
# a run's arrays: this rank's shard, the counters and the poses
MS_FIELDS = ("points", "normals", "colors", "features", "num_points", "num_dropped", "poses")

# name -> (mesh, frames, constructor arguments, the error's expected text)
MS_ERRORS = {
    "err_feature_width": ("mesh4", dict(B=1, L=2, H=8, W=8),
                          dict(map_capacity=4 * 16, feature_channels=2), "feature channel"),
    "err_capacity": ("mesh4", None, dict(map_capacity=1001), "divisible"),
    "err_requires_poses": ("mesh4", dict(B=1, L=2, H=8, W=8, no_poses=True),
                           dict(map_capacity=4 * 64), "requires poses"),
    "err_motion_model": ("mesh2", None, dict(map_capacity=2 * 256, motion_model="kalman"),
                         "motion_model"),
    "err_pyramid": ("mesh2", None, dict(map_capacity=2 * 256, pyramid=[(0, 1)]), "pyramid"),
    "err_robust": ("mesh2", None, dict(map_capacity=2 * 256, robust_loss="cauchy"), "robust"),
    "err_batch_divisible": ("mesh2d", dict(L3, L=2), dict(map_capacity=2 * 256,
                                                          batch_axis="dp"),
                            "divisible by the batch-axis"),
    "err_mesh_needs_batch_axis": ("mesh2d", None, dict(map_capacity=2 * 256), "batch_axis"),
    "err_mesh_no_axis": ("mesh2d", None, dict(map_capacity=2 * 256, batch_axis="nope"),
                         "no axis"),
    "err_same_axes": ("mesh2d", None, dict(map_capacity=2 * 256, batch_axis="map"),
                      "must differ"),
    "err_normal_pitch": ("mesh2", None, dict(map_capacity=2 * 256, normal_pitch=0),
                         "normal_pitch"),
    "err_assoc": ("mesh2", None, dict(map_capacity=2 * 16, odom_assoc="nearest"),
                  "odom_assoc"),
    "err_gate_gt": ("mesh2", None, dict(map_capacity=2 * 16, odom="gt", odom_angle_gate=60.0),
                    "odom_angle_gate"),
    "err_sym_knn": ("mesh2", None, dict(map_capacity=2 * 16, odom_sym_normals=True),
                    "projective"),
}


def frames_for(spec):
    """The port's frames of a spec: ``frames_np`` arguments plus
    ``features``, ``channels_first`` and ``no_poses``."""
    spec = dict(spec)
    feats, cf, no_poses = (spec.pop(k, False) for k in ("features", "channels_first",
                                                         "no_poses"))
    rgb, depth, K, poses = frames_np(**spec)
    frames = torch_frames(rgb, depth, K, None if no_poses else poses,
                          feature_image=labels_np(*rgb.shape[:4]) if feats else None)
    return frames.to_channels_first() if cf else frames


def _map_sharded_setup():
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    from gradslam_torch.parallel import make_mesh

    mesh4 = make_mesh(axis_name="map", device_type="cpu")
    mesh2d = DeviceMesh("cpu", torch.arange(4).reshape(2, 2), mesh_dim_names=("dp", "map"))
    return dict(mesh4=mesh4, mesh2d=mesh2d, mesh2=mesh2d["map"])


def _run(mesh, spec, kw):
    from gradslam_torch.parallel import MapShardedPointFusion, collectives

    def case(ctx):
        frames = frames_for(spec)
        collectives.reset_counts()
        smap, poses = MapShardedPointFusion(mesh=ctx[mesh], **kw)(frames)
        out = dict(points=smap.points, normals=smap.normals, colors=smap.colors,
                   features=smap.features, num_points=smap.num_points,
                   num_dropped=smap.num_dropped, poses=poses)
        out.update({f"bytes_{k}": v for k, v in collectives.BYTES.items()})
        pc = smap.to_pointclouds()
        out.update(pc_points=pc.points, pc_colors=pc.colors, pc_features=pc.features,
                   pc_num_points=pc.num_points, pc_num_dropped=pc.num_dropped)
        return {k: v.numpy() if hasattr(v, "numpy") else v for k, v in out.items()}

    return case


def _error(mesh, spec, kw):
    from gradslam_torch.parallel import MapShardedPointFusion

    def case(ctx):
        pipeline = MapShardedPointFusion(mesh=ctx[mesh], **kw)
        if spec is not None:
            pipeline(frames_for(spec))
        return {"no_error": np.asarray(True)}

    return case


def _volume(ctx):
    """Bytes by tag of a gt run at two capacities and of a projective run
    (``tests/parallel/test_map_sharded.py``'s collective-volume case)."""
    from gradslam_torch.parallel import MapShardedPointFusion, collectives

    frames = frames_for(dict(B=1, L=2, H=16, W=24))
    out = {}
    for name, kw in (("small", dict(map_capacity=4 * 256)), ("big", dict(map_capacity=4 * 2048)),
                     ("proj", dict(map_capacity=4 * 256, odom="gradicp",
                                   odom_assoc="projective", dsratio=2, numiters=2))):
        collectives.reset_counts()
        MapShardedPointFusion(mesh=ctx["mesh4"], **kw)(frames)
        for tag in ("fusion", "window", "normal_eq"):
            out[f"{name}_{tag}"] = np.asarray([collectives.BYTES[tag], collectives.CALLS[tag]])
    return out


def _knn(ctx):
    """``nn_points_map_sharded`` on the 4-rank map axis: each rank holds 50
    target rows."""
    import torch

    from gradslam_torch.parallel import nn_points_map_sharded

    rng = np.random.RandomState(0)
    src = torch.from_numpy(rng.randn(100, 3).astype(np.float32))
    tgt = torch.from_numpy(rng.randn(4 * 50, 3).astype(np.float32))
    mask = torch.from_numpy(rng.rand(4 * 50) < 0.8)
    r = torch.distributed.get_rank()
    d, i = nn_points_map_sharded(src, tgt[r * 50:(r + 1) * 50], mask[r * 50:(r + 1) * 50],
                                 axis_name="map", mesh=ctx["mesh4"])
    return dict(dist=d.numpy(), idx=i.numpy())


def _use_jit(ctx):
    """``use_jit`` on CPU tensors without the emulation: the run is eager,
    and says why."""
    from gradslam_torch.parallel import MapShardedPointFusion

    out = {}
    for flag in (True, False):
        p = MapShardedPointFusion(map_capacity=4 * 64, mesh=ctx["mesh4"], use_jit=flag)
        p(frames_for(dict(B=1, L=2, H=8, W=8)))
        out[f"reason_{flag}"] = np.asarray(p.last_eager_reason)
        out[f"captured_{flag}"] = np.asarray(p.last_call_captured)
        out[f"graphs_{flag}"] = np.asarray(len(p.frame_graphs))
    return dict(out, K=np.asarray(p.K))


def _counted_run(pipeline, frames):
    """One run with every counter from 0: this rank's arrays (copies), the
    kernels' launches and the collectives' bytes and calls by tag."""
    from gradslam_torch.ops import knn_cuda, scatter_cuda
    from gradslam_torch.parallel import collectives

    knn_cuda.launches = scatter_cuda.launches = 0
    collectives.reset_counts()
    smap, poses = pipeline(frames)
    arrays = {f: getattr(smap, f).clone() for f in MS_FIELDS[:-1]}
    arrays["poses"] = poses.clone()
    counts = dict(knn=knn_cuda.launches, scatter=scatter_cuda.launches,
                  **{f"bytes_{k}": v for k, v in collectives.BYTES.items()},
                  **{f"calls_{k}": v for k, v in collectives.CALLS.items()})
    return arrays, smap, poses, counts


def _captured(name):
    """Row ``name`` with ``use_jit=False`` and then twice captured (the
    capture emulated: the first call warms up and captures, the second
    replays every frame after the first), launches counted at the
    dispatchers: each run's arrays and counts (``eager_*``, ``first_*``,
    ``second_*``), the first result as the caller held it after the second
    call (``held_*``), and the captured pipeline's record."""
    mesh, spec, kw = MS_RUNS[name]

    def case(ctx):
        import json

        import pytest

        from gradslam_torch.parallel import MapShardedPointFusion

        from ._graph_emulation import count_at_dispatchers, emulate

        frames = frames_for(spec)
        out = {}
        with pytest.MonkeyPatch.context() as mp:
            count_at_dispatchers(mp)
            runs = {"eager": _counted_run(MapShardedPointFusion(mesh=ctx[mesh], use_jit=False,
                                                                **kw), frames)}
            emulate(mp)
            jit = MapShardedPointFusion(mesh=ctx[mesh], **kw)
            for call in ("first", "second"):
                runs[call] = _counted_run(jit, frames)
                out[f"{call}_captured"] = np.asarray(jit.last_call_captured)
            first = runs["first"]
            out.update({f"held_{f}": v.numpy() for f, v in zip(
                MS_FIELDS, (*(getattr(first[1], f) for f in MS_FIELDS[:-1]), first[2]))})
        for call, (arrays, _, _, counts) in runs.items():
            out.update({f"{call}_{f}": v.numpy() for f, v in arrays.items()})
            out[f"{call}_counts"] = np.asarray(json.dumps(counts, sort_keys=True))
        out["graphs"] = np.asarray(len(jit.frame_graphs))
        out["keys"] = np.asarray(sorted({key[0] for key in jit.frame_graphs._entries}))
        out["replays"] = np.asarray(jit.frame_graphs.replays)
        return out

    return case


def _failed_capture(ctx):
    """A capture of the sharded body that fails raises, and the pipeline
    stores no graph."""
    import pytest

    from gradslam_torch.parallel import MapShardedPointFusion
    from gradslam_torch.utils.graphs import FrameGraphs

    from ._graph_emulation import emulate

    def refuses(self, fn, device):
        raise RuntimeError("operation not permitted when stream is capturing")

    with pytest.MonkeyPatch.context() as mp:
        emulate(mp)
        mp.setattr(FrameGraphs, "_graph", refuses)
        pipeline = MapShardedPointFusion(mesh=ctx["mesh2"], map_capacity=2 * 512)
        try:
            pipeline(frames_for(L3))
            raised = ""
        except RuntimeError as e:
            raised = str(e)
    return dict(raised=np.asarray(raised), graphs=np.asarray(len(pipeline.frame_graphs)))


MAP_SHARDED = dict(
    setup=_map_sharded_setup,
    cases={**{n: _run(*v) for n, v in MS_RUNS.items()},
           **{n: _error(*v[:3]) for n, v in MS_ERRORS.items()},
           **{f"captured_{n}": _captured(n) for n in MS_CAPTURED},
           "volume": _volume, "knn": _knn, "use_jit": _use_jit,
           "failed_capture": _failed_capture},
)

# --------------------------------------------------------------------------- #
# DataParallelSLAM (world of 2)
# --------------------------------------------------------------------------- #

B8 = dict(B=8, L=2, H=16, W=24)


def _sharding_setup():
    from gradslam_torch.parallel import make_mesh

    return dict(mesh=make_mesh(device_type="cpu"))


def _dp_forward(kw, spec=B8):
    def case(ctx):
        from gradslam_torch import PointFusion
        from gradslam_torch.parallel import DataParallelSLAM

        dp = DataParallelSLAM(PointFusion(**kw), ctx["mesh"])
        pc, poses = dp(frames_for(spec))
        return dict(points=pc.points.numpy(), num_points=pc.num_points.numpy(),
                    features=pc.features.numpy(), poses=poses.numpy())

    return case


def _dp_grad(ctx):
    """Gradients of ``sum(points ** 2)`` over the gathered batch to every
    rank's depths and intrinsics (whole-batch tensors: each rank's gradient
    is nonzero in its own block only)."""
    import torch

    from gradslam_torch import PointFusion
    from gradslam_torch.parallel import DataParallelSLAM

    rgb, depth, K, poses = frames_np(**B8)
    depth_t = torch.from_numpy(depth).requires_grad_(True)
    K_t = torch.from_numpy(K).requires_grad_(True)
    frames = torch_frames(rgb, depth, K, poses)
    frames = frames.__class__(rgb_image=frames.rgb_image, depth_image=depth_t,
                              intrinsics=K_t, poses=frames.poses)
    pc, _ = DataParallelSLAM(PointFusion(odom="gt"), ctx["mesh"])(frames)
    loss = torch.sum(pc.points ** 2)
    loss.backward()
    return dict(loss=loss.detach().numpy(), g_depth=depth_t.grad.numpy(),
                g_intr=K_t.grad.numpy())


def _dp_step(ctx):
    """``step`` with the constant-velocity prior, two frames."""
    import torch

    from gradslam_torch import ICPSLAM
    from gradslam_torch.parallel import DataParallelSLAM

    frames = frames_for(B8)
    dp = DataParallelSLAM(ICPSLAM(odom="icp", dsratio=2, numiters=2), ctx["mesh"])
    pc = dp.slam.empty_map(8, 2 * 16 * 24, device="cpu")
    pc, pose = dp.step(pc, frames[:, 0])
    prev = frames[:, 0].with_poses(pose)
    eye = torch.eye(4).expand(8, 4, 4)
    pc, pose2 = dp.step(pc, frames[:, 1], prev, prev_transform=eye)
    return dict(pose=pose.numpy(), pose2=pose2.numpy(), points=pc.points.numpy(),
                num_points=pc.num_points.numpy())


def _dp_indivisible(ctx):
    from gradslam_torch.parallel import shard_frames

    shard_frames(frames_for(dict(B8, B=3)), ctx["mesh"])
    return {"no_error": np.asarray(True)}


def _dp_placements(ctx):
    import torch

    from gradslam_torch.parallel import (
        batch_sharding,
        map_sharded_spec,
        shard_frames,
        shard_pointclouds,
    )
    from gradslam_torch.slam.icpslam import ICPSLAM

    mesh = ctx["mesh"]
    frames = frames_for(B8)
    block = shard_frames(frames, mesh)
    pc = ICPSLAM(odom="gt").empty_map(8, 16, device="cpu")
    pc = pc.__class__(**{**{f: getattr(pc, f) for f in ("points", "normals", "colors",
                                                        "features", "num_dropped")},
                         "num_points": torch.arange(8)})
    sharded = shard_pointclouds(pc, mesh)
    return dict(batch=np.asarray(repr(batch_sharding(mesh))),
                map=np.asarray(repr(map_sharded_spec(mesh))),
                depth=block.depth_image.numpy(), num_points=sharded.num_points.numpy())


SHARDING = dict(
    setup=_sharding_setup,
    cases={
        "forward": _dp_forward(dict(odom="gt")),
        "features": _dp_forward(dict(odom="gt", feature_channels=2), dict(B8, features=True)),
        "tracked": _dp_forward(dict(odom="gradicp", dsratio=2, numiters=2, map_capacity=1024)),
        "grad": _dp_grad,
        "step": _dp_step,
        "indivisible": _dp_indivisible,
        "placements": _dp_placements,
    },
)
