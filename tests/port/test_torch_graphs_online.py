"""The online calls under autograd replayed as CUDA graphs: ``step``,
``localize`` and ``map_update`` on inputs that need a gradient run each
call as one autograd node whose forward and backward replay graphs
(``ICPSLAM._online``, ``FrameGraphs.grad``), as the JAX package jits
``_step``, ``_localize_impl`` and the map-only update under ``jax.grad``.
The capture is emulated on the CPU (``tests/port/_graph_emulation.py``).
Eagerly each input that needs a gradient goes through one view at the
call's entry, so a call sums its uses' gradients before the caller's, as
the captured call's backward does: the ``localize`` -> ``map_update`` loop
fails the bit test without it (the pose and the map each feed both calls).

- A step loop (gt, and the tracked gradICP with the constant-velocity
  prior) and a ``localize`` -> ``map_update`` loop, ``remat`` on and off,
  five steps on a 24x32 clip: every step's map, poses and gradients to the
  depth and the intrinsics (of that step's loss, taken right after it) are
  the ``use_jit=False`` bits; after the loop every result the caller holds
  and every step's gradients, taken again, are unchanged: nothing of a
  later call leaks into an earlier one.
- The captured step loop's gradients against ``jax.grad`` through the JAX
  package's jitted step loop on the gradient tests' clip, at the bars of
  ``tests/port/test_torch_grad*.py`` (1e-4 of max |g| gt, 1e-3 tracked).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import gradslam_tpu as G  # noqa: E402
from gradslam_torch import PointFusion, RGBDImages  # noqa: E402
from gradslam_torch.geometry.geometryutils import (  # noqa: E402
    compose_transformations,
    inverse_transformation,
)
from gradslam_torch.utils.graphs import clone_tree, flatten  # noqa: E402
from gradslam_tpu.datasets import synthetic_sequence  # noqa: E402

from . import _gradparity as GP  # noqa: E402
from ._graph_emulation import emulate  # noqa: E402


from ._threads import one_thread  # noqa: E402,F401


L, H, W = 5, 24, 32
TRACKED = dict(odom="gradicp", dsratio=4, numiters=3, motion_model="constant_velocity")
LOOPS = {  # name -> (pipeline arguments, split into localize and map_update)
    "gt_step": (dict(odom="gt"), False),
    "tracked_step": (TRACKED, False),
    "tracked_localize_map_update": (TRACKED, True),
}


def _same(a, b) -> bool:
    la, sa = flatten(a)
    lb, sb = flatten(b)
    return sa == sb and all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def _loop(slam, frames, split, each_step, jax_side=False):
    """The online loop of ``examples/online_slam.py``: frame 0 bootstraps at
    its pose; each later frame is tracked from the previous pose, with the
    previous motion as the prior under ``constant_velocity`` (gt: fused at
    its own pose); with ``split`` each step is ``localize`` then
    ``map_update``. After each step ``each_step(map, poses so far)``."""
    compose = G.compose_transformations if jax_side else compose_transformations
    inverse = G.inverse_transformation if jax_side else inverse_transformation
    B, n = frames.shape[:2]
    tracked = slam.odom != "gt"
    cv = slam.motion_model == "constant_velocity"
    empty = (slam.empty_map(B, n * H * W) if jax_side
             else slam.empty_map(B, n * H * W, device="cpu"))
    pc, pose = slam.step(empty, frames[:, 0])
    poses = [pose[:, 0]]
    delta = (jnp.broadcast_to(jnp.eye(4), (B, 4, 4)) if jax_side
             else torch.eye(4).expand(B, 4, 4)) if cv else None
    each_step(pc, poses)
    for f in range(1, n):
        live = frames[:, f]
        prev = frames[:, f - 1].with_poses(poses[-1][:, None]) if tracked else None
        if split:
            pose = slam.localize(pc, live, prev, prev_transform=delta)
            pc = slam.map_update(pc, live.with_poses(pose))
        else:
            pc, pose = slam.step(pc, live, prev, prev_transform=delta)
        if not jax_side:
            assert slam.last_call_captured == slam.use_jit
        if cv:
            delta = compose(pose[:, 0], inverse(poses[-1]))
        poses.append(pose[:, 0])
        each_step(pc, poses)


def _loss(pc, poses, tracked, stack=torch.stack):
    """``sum(points^2)`` of the map, plus ``sum(t^2)`` of the poses so far
    for tracked loops."""
    loss = (pc.points ** 2).sum()
    if tracked:
        loss = loss + (stack(poses, 1)[..., :3, 3] ** 2).sum()
    return loss


def _run(slam, arrays, split=False):
    """The loop on leaves that need a gradient: each step's ``(map, poses,
    g_depth, g_K)``, the gradients of that step's loss taken right after
    it; copies of them taken then; and each step's gradients taken again
    after the loop."""
    rgb, depth, K, P = (torch.from_numpy(np.asarray(a, np.float32)) for a in arrays[:4])
    depth.requires_grad_()
    K.requires_grad_()
    tracked = slam.odom != "gt"
    steps, held, losses = [], [], []

    def each_step(pc, poses):
        loss = _loss(pc, poses, tracked)
        gd, gk = torch.autograd.grad(loss, (depth, K), retain_graph=True)
        losses.append(loss)
        steps.append((pc, torch.stack(poses, dim=1), gd, gk))
        held.append(clone_tree(steps[-1]))

    _loop(slam, RGBDImages(rgb, depth, K, P), split, each_step)
    again = [torch.autograd.grad(loss, (depth, K), retain_graph=True) for loss in losses]
    return steps, held, again


@pytest.mark.parametrize("remat", [False, True], ids=["remat_off", "remat_on"])
@pytest.mark.parametrize("name", list(LOOPS))
def test_online_calls_captured_under_grad_give_the_eager_bits(monkeypatch, name, remat):
    """Every step's map, poses and gradients are the eager bits; the calls
    replay forward and backward graphs; the results held and each step's
    gradients taken again after the loop are unchanged."""
    kw, split = LOOPS[name]
    arrays = synthetic_sequence(1, L, H, W, seed=0)
    want, _, _ = _run(PointFusion(use_jit=False, remat=remat, **kw), arrays, split)
    emulate(monkeypatch)
    slam = PointFusion(remat=remat, **kw)
    got, held, again = _run(slam, arrays, split)
    assert slam.last_call_captured and slam.last_eager_reason is None
    counts = slam.frame_graphs.counts()
    assert counts["backward"] > 0 and slam.frame_graphs.replays > 0
    assert (counts["frame"] > 0) == remat and (counts["forward"] > 0) != remat
    for f, (g, w, h, a) in enumerate(zip(got, want, held, again)):
        assert _same(g, w), f"step {f}: the captured step differs from eager"
        assert _same(g, h), f"step {f}: a later step changed this step's results"
        assert _same(a, g[2:]), f"step {f}: its gradients changed after later steps"
    assert not torch.equal(got[-1][2], got[-2][2])


def test_online_calls_under_grad_replay_their_graphs(monkeypatch):
    """A steady step loop captures nothing new: from the sixth step on
    each step replays its forward (remat off: with an arena of its own)
    and the backwards of its loss."""
    emulate(monkeypatch)
    slam = PointFusion(**TRACKED)
    arrays = synthetic_sequence(1, 6, H, W, seed=0)
    rgb, depth, K, P = (torch.from_numpy(np.asarray(a, np.float32)) for a in arrays[:4])
    depth.requires_grad_()
    frames = RGBDImages(rgb, depth, K, P)
    seen = []

    def each_step(pc, poses):
        _loss(pc, poses, True).backward(retain_graph=True)
        seen.append((slam.frame_graphs.counts(), slam.frame_graphs.replays,
                     slam.frame_graphs.kept_bytes))

    _loop(slam, frames, False, each_step)
    (c4, r4, k4), (c5, r5, k5) = seen[4], seen[5]
    assert c5 == c4 and r5 > r4 and k5 > k4


_JAX = {}


def _jax_grads(kw, data, tracked):
    """``jax.grad`` of the loop's last loss through the JAX package's
    jitted step loop (``use_jit=True``: ``_step`` and the map-only update
    jitted): ``(g_depth, g_K)``."""
    key = (tuple(sorted(kw.items())), tracked)
    if key not in _JAX:
        rgb, depth, K, P = (jnp.asarray(a) for a in data[:4])
        slam = G.PointFusion(**kw)

        def loss(d, k):
            out = []
            _loop(slam, G.RGBDImages(rgb, d, k, P), False,
                  lambda pc, poses: out.append(_loss(pc, poses, tracked, jnp.stack)),
                  jax_side=True)
            return out[-1]

        gd, gk = jax.grad(loss, argnums=(0, 1))(depth, K)
        _JAX[key] = np.asarray(gd), np.asarray(gk)
    return _JAX[key]


@pytest.fixture(scope="module")
def grad_clip():
    return GP.clip()


@pytest.mark.parametrize("remat", [False, True], ids=["remat_off", "remat_on"])
@pytest.mark.parametrize("name,bar", [("gt", 1e-4), ("tracked", 1e-3)])
def test_captured_step_loop_gradients_against_the_jax_packages_grad(monkeypatch, grad_clip,
                                                                    name, bar, remat):
    """The emulated captured step loop's gradients of its last loss to the
    depth and the intrinsics against ``jax.grad`` through JAX's jitted step
    loop on the same numpy clip (with 5% of the depths zeroed)."""
    kw = dict(odom="gt") if name == "gt" else dict(odom="gradicp", dsratio=2, numiters=3)
    tracked = name == "tracked"
    jd, jk = _jax_grads(kw, grad_clip, tracked)
    emulate(monkeypatch)
    slam = PointFusion(remat=remat, **kw)
    for _ in range(2):  # the second loop replays every call
        steps, _, _ = _run(slam, grad_clip)
    assert slam.last_call_captured and slam.frame_graphs.replays > 0
    gd, gk = steps[-1][2:]
    for got, want in ((gd, jd), (gk, jk)):
        scale = float(np.abs(want).max())
        assert scale > 0 and GP.max_gap(got.numpy(), want) <= bar * scale
