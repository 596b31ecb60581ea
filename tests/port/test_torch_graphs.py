"""``use_jit`` in the port: the frame body as a CUDA graph
(``gradslam_torch/utils/graphs.py``), tested on the CPU.

- Which calls are captured (:func:`eager_reason`, a pure function).
- The cache key: a new capacity, shape, dtype, option or static field gives
  a new entry.
- ``flatten``/``unflatten`` round-trip ``Pointclouds`` and ``RGBDImages``
  bit for bit.
- The launch counters: a capture takes back its own increments, the warm-up
  counts what it launched, each replay adds what the capture recorded (the
  torch.cuda calls replaced by stand-ins, the graph by an object that
  counts its replays); a failed capture raises and stores nothing.
- The pipelines' wiring, with the capture emulated on the CPU (a stand-in
  graph whose replay runs the body again and writes into the same static
  outputs, as a replay does): ``forward`` (gt and tracked), ``step``,
  ``localize`` and ``map_update`` give ``use_jit=False``'s bits, one graph
  for each capacity segment, and a result the caller holds is unchanged by
  later replays; the emulated gt forward against the JAX package's jitted
  one. On the CPU itself ``use_jit=True`` runs eagerly, with the same bits,
  and says why.
- Gradients (``FrameGraphs.grad``), the backward emulated the same way: a
  replay writes into the same static outputs, residual arena and gradient
  buffers. Captured gradients (gt and tracked, ``remat`` on and off,
  ``PointFusion`` and ``ICPSLAM``'s aggregate map) give the eager bits over
  three steps, and a held step's gradients are unchanged by the next; two
  frames through one key show the overwrite trap when the per-call copies
  are not written back; ``refine()``'s steps replay with the eager bits;
  the captured gradients against jitted ``jax.grad``. The online calls are
  captured under grad too (``test_torch_graphs_online.py`` holds their
  bits); armed recovery is captured (``test_torch_graphs_armed.py``).
"""

import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import gradslam_tpu as G  # noqa: E402
from gradslam_torch import ICPSLAM, Pointclouds, PointFusion  # noqa: E402
from gradslam_torch.interop import rgbdimages_from_numpy  # noqa: E402
from gradslam_torch.ops import knn_cuda, scatter_cuda  # noqa: E402
from gradslam_torch.parallel import collectives  # noqa: E402
from gradslam_torch.slam import icpslam as icpslam_module  # noqa: E402
from gradslam_torch.utils import graphs  # noqa: E402
from gradslam_torch.utils.graphs import (  # noqa: E402
    CapturedCall,
    FrameGraphs,
    clone_tree,
    cache_key,
    eager_reason,
    eager_reason_for,
    flatten,
    unflatten,
)
from gradslam_tpu.datasets import synthetic_sequence  # noqa: E402

from ._graph_emulation import StandInGraph, emulate, emulated_graph, fake_cuda  # noqa: E402


from ._threads import one_thread  # noqa: E402,F401


L, H, W = 6, 24, 32
SCHEDULE = [(2, 2 * H * W), (2, 4 * H * W), (2, 6 * H * W)]


def _frames(B=1, seed=0, L_=L, H_=H, W_=W):
    return rgbdimages_from_numpy(*synthetic_sequence(B, L_, H_, W_, seed=seed), device="cpu")


def _same(a, b) -> bool:
    la, sa = flatten(a)
    lb, sb = flatten(b)
    return sa == sb and all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


# ---------------------------------------------------------------------- #
# Which calls are captured
# ---------------------------------------------------------------------- #
def _pipeline_reason(use_jit, on_card, grad, armed):
    """The reason a tracked pipeline, armed (``relocalize_below > 0``) or
    not, records for a call on these facts (``_plan``)."""
    slam = PointFusion(odom="gradicp", use_jit=use_jit, relocalize_below=0.2 if armed else 0.0)
    depth = _frames(L_=2).depth_image.clone().requires_grad_(grad)
    with pytest.MonkeyPatch.context() as mp:
        if on_card:
            mp.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
        slam._plan(depth)
    return slam.last_eager_reason


# armed recovery is captured as unarmed calls are: arming changes no answer
@pytest.mark.parametrize("use_jit,on_card,grad,armed,want", [
    (True, True, False, False, None),
    (False, True, False, False, "use_jit=False"),
    (True, False, False, False, "inputs not on the card"),
    (True, True, True, False, None),  # every call captures its gradients
    (True, True, False, True, None),
    (False, False, True, True, "use_jit=False"),
])
def test_eager_reason(use_jit, on_card, grad, armed, want):
    assert eager_reason(use_jit, on_card) == want
    assert _pipeline_reason(use_jit, on_card, grad, armed) == want


@pytest.mark.parametrize("on_card,grad,armed,want", [
    (True, True, False, None),  # forward, step, localize, map_update capture gradients
    (True, True, True, None),  # ... armed too
    (False, True, False, "inputs not on the card"),
    (False, True, True, "inputs not on the card"),
    (True, False, False, None),
])
def test_eager_reason_under_grad(on_card, grad, armed, want):
    """Under grad a call on the card is captured: no call of the port runs
    eagerly for needing a gradient."""
    assert eager_reason(True, on_card) == want
    assert _pipeline_reason(True, on_card, grad, armed) == want


def test_eager_reason_reads_the_tensors():
    frames = _frames(L_=2)
    assert eager_reason_for(True, frames) == "inputs not on the card"
    depth = frames.depth_image.clone().requires_grad_()
    # on a (pretended) card every call is captured, in grad mode or not
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
        assert eager_reason_for(True, frames) is None
        assert _pipeline_reason(True, True, False, armed=True) is None
        assert eager_reason_for(True, depth) is None
        assert eager_reason_for(False, depth) == "use_jit=False"
        with torch.no_grad():
            assert eager_reason_for(True, depth) is None


# ---------------------------------------------------------------------- #
# The cache key and the flattening
# ---------------------------------------------------------------------- #
def _key(name, options, args):
    return cache_key(name, options, *flatten(args))


def test_cache_key_changes_with_capacity_shape_dtype_option_and_static_fields():
    slam = PointFusion(odom="gt")
    frames = _frames(L_=2)
    small = slam.empty_map(1, 2 * H * W, device="cpu")
    key = _key("map", (), (small, frames[:, 0]))
    assert key == _key("map", (), (slam.empty_map(1, 2 * H * W, device="cpu"),
                                              frames[:, 1]))
    others = [
        _key("map", (), (slam.empty_map(1, 3 * H * W, device="cpu"), frames[:, 0])),
        _key("map", (), (small, _frames(L_=2, H_=H // 2)[:, 0])),
        _key("map", (), (slam.empty_map(2, 2 * H * W, device="cpu"),
                                    _frames(B=2, L_=2)[:, 0])),
        _key("map", (), (slam.empty_map(1, 2 * H * W, device="cpu",
                                                   dtype=torch.float64), frames[:, 0])),
        _key("map", (True,), (small, frames[:, 0])),
        _key("track", (), (small, frames[:, 0])),
        _key("map", (), (small, frames[:, 0].with_poses(None))),
        _key("map", (), (small, _frames(L_=2)[:, 0].__class__(
            **{**{f: getattr(frames[:, 0], f) for f in frames[:, 0].__dataclass_fields__},
               "normal_pitch": 2}))),
        _key("map", (), (PointFusion(odom="gt", feature_channels=2).empty_map(
            1, 2 * H * W, device="cpu"), frames[:, 0])),
    ]
    assert len({key, *others}) == len(others) + 1


def test_flatten_round_trips_pointclouds_and_rgbdimages_bit_for_bit():
    rng = np.random.RandomState(0)
    frames = _frames(B=2, L_=3)
    frames = frames.__class__(frames.rgb_image, frames.depth_image, frames.intrinsics,
                              frames.poses, feature_image=torch.from_numpy(
                                  rng.rand(2, 3, H, W, 4).astype(np.float32)), normal_pitch=3)
    pc = Pointclouds(points=torch.randn(2, 50, 3), num_points=torch.tensor([7, 50]),
                     normals=torch.randn(2, 50, 3), features=torch.randn(2, 50, 2),
                     num_dropped=torch.tensor([0, 3]))
    tree = (pc, frames, None, torch.eye(4)[None], 5)
    leaves, spec = flatten(tree)
    assert len(leaves) == 5 + 5 + 1
    back = unflatten(spec, [t.clone() for t in leaves])
    assert _same(back, tree) and back[4] == 5 and back[2] is None
    assert back[1].normal_pitch == 3 and back[0].colors is None
    assert back[0].points.data_ptr() != pc.points.data_ptr()
    copy = clone_tree(tree)
    assert _same(copy, tree) and copy[0].points.data_ptr() != pc.points.data_ptr()
    with pytest.raises(ValueError):
        unflatten(spec, leaves + [torch.zeros(1)])


# ---------------------------------------------------------------------- #
# The launch counters
# ---------------------------------------------------------------------- #
@pytest.fixture
def counters(monkeypatch):
    monkeypatch.setattr(knn_cuda, "launches", 0)
    monkeypatch.setattr(scatter_cuda, "launches", 0)
    saved = dict(collectives.BYTES), dict(collectives.CALLS)
    collectives.reset_counts()
    yield
    collectives.reset_counts()
    collectives.BYTES.update(saved[0])
    collectives.CALLS.update(saved[1])


def _tallies():
    return dict(collectives.BYTES), dict(collectives.CALLS)


def test_a_replay_adds_the_launches_its_capture_recorded(counters):
    """A replay adds what its capture counted on every counter: the
    kernels' launches and the collectives' bytes and calls by tag."""
    static_in, static_out = [torch.zeros(3)], [torch.ones(2)]
    counts = {(knn_cuda.__name__, None): 2, (scatter_cuda.__name__, None): 3,
              ("collectives.BYTES", "fusion"): 48, ("collectives.CALLS", "fusion"): 1}
    call = CapturedCall(StandInGraph(), static_in, static_out, flatten(torch.ones(2))[1], counts)
    src = torch.arange(3.0)
    for n in (1, 2, 3):
        out = call([src])
        assert (knn_cuda.launches, scatter_cuda.launches) == (2 * n, 3 * n)
        assert _tallies() == ({"fusion": 48 * n}, {"fusion": n})
        assert call.graph.replays == n and out is static_out[0]
        assert torch.equal(static_in[0], src)


def _body(x):
    """Stands in for a frame body: two 1-NN and one scatter launch, and
    one collective's count."""
    knn_cuda.launches += 2
    scatter_cuda.launches += 1
    collectives._count("fusion", x)
    return x + 1


def test_capture_takes_back_its_increments_and_replays_add_them(monkeypatch, counters):
    fake_cuda(monkeypatch)
    cache = FrameGraphs()
    x = torch.zeros(4)
    first = cache("body", _body, (x,))
    assert torch.equal(first, x + 1)  # the warm-up's result
    assert (knn_cuda.launches, scatter_cuda.launches) == (2, 1)  # the warm-up only
    assert _tallies() == ({"fusion": 16}, {"fusion": 1})
    assert len(cache) == 1 and cache.capture_s >= 0.0
    for n in (1, 2):
        cache("body", _body, (x,))
        assert (knn_cuda.launches, scatter_cuda.launches) == (2 + 2 * n, 1 + n)
        assert _tallies() == ({"fusion": 16 * (1 + n)}, {"fusion": 1 + n})
    cache("body", _body, (torch.zeros(5),))  # a new shape: warm-up and capture again
    assert len(cache) == 2 and (knn_cuda.launches, scatter_cuda.launches) == (8, 4)
    assert _tallies() == ({"fusion": 68}, {"fusion": 4})
    cache.clear()
    assert len(cache) == 0 and cache._pool is None


def test_a_failed_capture_raises_and_stores_nothing(monkeypatch, counters):
    fake_cuda(monkeypatch)
    calls = []

    def breaks_under_capture(x):
        calls.append(1)
        knn_cuda.launches += 1
        if len(calls) == 2:  # the capture
            raise RuntimeError("operation not permitted when stream is capturing")
        return x * 2

    cache = FrameGraphs()
    with pytest.raises(RuntimeError, match="capture of the 'odd' frame body .*not permitted"):
        cache("odd", breaks_under_capture, (torch.ones(2),))
    assert len(cache) == 0 and knn_cuda.launches == 1


def test_the_capture_runs_with_the_garbage_collector_off(monkeypatch):
    """A collection inside a capture could destroy an unreachable
    pipeline's graphs, which breaks the capture: ``_graph`` turns the
    collector off around it (and back on, also when the capture fails),
    and captures in the default ("global") error mode."""
    import gc

    fake_cuda(monkeypatch)
    modes = []
    monkeypatch.setattr(torch.cuda, "graph", lambda g, pool=None, stream=None,
                        capture_error_mode="global": modes.append(capture_error_mode)
                        or contextlib.nullcontext())
    seen = []
    cache = FrameGraphs()
    cache._side_stream(None)
    _, out = cache._graph(lambda: seen.append(gc.isenabled()) or 7, None)
    assert out == 7 and seen == [False] and gc.isenabled() and modes == ["global"]

    def fails():
        raise RuntimeError("capture invalidated")

    with pytest.raises(RuntimeError):
        cache._graph(fails, None)
    assert gc.isenabled()


# ---------------------------------------------------------------------- #
# The pipelines, with the capture emulated on the CPU
# ---------------------------------------------------------------------- #
@pytest.fixture
def emulated(monkeypatch):
    emulate(monkeypatch)


TRACKED = dict(odom="gradicp", dsratio=4, numiters=3, motion_model="constant_velocity")


@pytest.mark.parametrize("cls,kw", [
    (PointFusion, dict(odom="gt")),
    (PointFusion, TRACKED),
    (ICPSLAM, dict(odom="icp", dsratio=4, numiters=3)),
])
def test_forward_captured_gives_the_eager_bits(emulated, cls, kw):
    frames = _frames()
    eager = cls(map_capacity=SCHEDULE, use_jit=False, **kw)
    jit = cls(map_capacity=SCHEDULE, **kw)
    want = eager(frames)
    assert not eager.last_call_captured and eager.last_eager_reason == "use_jit=False"
    first = jit(frames)
    assert jit.last_call_captured and jit.last_eager_reason is None
    assert len(jit.frame_graphs) == len(SCHEDULE)  # one graph a capacity segment
    replays = jit.frame_graphs.replays
    assert replays == L - len(SCHEDULE) - (kw["odom"] != "gt")  # warm-ups and frame 0 eager
    held = clone_tree(first)
    second = jit(frames)  # every frame replays
    assert jit.frame_graphs.replays == replays + L - (kw["odom"] != "gt")
    assert _same(first, want) and _same(second, want)
    assert _same(first, held)  # later replays leave the first result alone


def test_step_localize_and_map_update_captured_give_the_eager_bits(emulated):
    frames = _frames()
    cap = L * H * W

    def loop(slam, split):
        pc, pose = slam.step(slam.empty_map(1, cap, device="cpu"), frames[:, 0])
        held = [clone_tree(pc)]
        outs = [pc]
        poses = [pose[:, 0]]
        delta = torch.eye(4).expand(1, 4, 4)
        for f in range(1, L):
            prev = frames[:, f - 1].with_poses(poses[-1][:, None])
            if split:
                pose = slam.localize(pc, frames[:, f], prev, prev_transform=delta)
                assert slam.last_call_captured == slam.use_jit
                pc = slam.map_update(pc, frames[:, f].with_poses(pose))
            else:
                pc, pose = slam.step(pc, frames[:, f], prev, prev_transform=delta)
            assert slam.last_call_captured == slam.use_jit
            delta = icpslam_module.compose_transformations(
                pose[:, 0], icpslam_module.inverse_transformation(poses[-1]))
            poses.append(pose[:, 0])
            outs.append(pc)
            held.append(clone_tree(pc))
        assert all(_same(a, b) for a, b in zip(outs, held))  # results the caller holds
        return pc, torch.stack(poses, dim=1)

    want = loop(PointFusion(use_jit=False, **TRACKED), False)
    for split in (False, True):
        slam = PointFusion(**TRACKED)
        assert _same(loop(slam, split), want)
        assert slam.frame_graphs.replays > 0
    fwd = PointFusion(map_capacity=cap, **TRACKED)
    assert _same(fwd(frames), want)


def test_gradients_and_armed_recovery_run_eagerly(emulated):
    """Under grad the online calls (``step``, ``map_update``) are captured
    as ``forward`` is: each call replays forward and backward graphs
    (``test_torch_graphs_online.py`` holds their bits). Armed recovery no
    longer runs eagerly either: an armed ``forward`` is captured, without
    gradients as one graph a frame whose branches are conditional nodes
    (key ``'armed'``), under autograd as a gate and a fuse graph a capacity
    segment (``test_torch_graphs_armed.py`` holds its bits)."""
    frames = _frames(L_=3)
    depth = frames.depth_image.clone().requires_grad_()
    grad_frames = frames.__class__(frames.rgb_image, depth, frames.intrinsics, frames.poses)
    slam = PointFusion(odom="gt")
    pc, _ = slam.step(slam.empty_map(1, 3 * H * W, device="cpu"), grad_frames[:, 0])
    assert slam.last_call_captured and slam.last_eager_reason is None
    for f in (1, 2):  # the second map update replays the first's graphs
        pc = slam.map_update(pc, grad_frames[:, f])
        assert slam.last_call_captured and slam.last_eager_reason is None
    pc.points.sum().backward()
    assert depth.grad is not None and slam.frame_graphs.counts()["backward"] > 0
    assert slam.frame_graphs.replays > 0
    # five frames: from the third tracked frame on, each frame's inputs
    # that need a gradient are the same and its keys replay
    frames = _frames(L_=5)
    depth = frames.depth_image.clone().requires_grad_()
    grad_frames = frames.__class__(frames.rgb_image, depth, frames.intrinsics, frames.poses)
    armed = PointFusion(odom="gradicp", dsratio=4, numiters=2, relocalize_below=0.2)
    armed(frames)
    assert armed.last_call_captured and armed.last_eager_reason is None
    assert sorted({key[0] for key in armed.frame_graphs._entries}) == ["armed"]
    pc, _ = armed(grad_frames)
    assert armed.last_call_captured and armed.last_eager_reason is None
    depth.grad = None
    pc.points.sum().backward()
    assert depth.grad is not None and armed.frame_graphs.counts()["backward"] > 0


def test_emulated_capture_against_the_jax_packages_jit():
    """The slice as a whole: the gt forward with its frames replayed (the
    capture emulated) against ``jax.jit``'s, on the same arrays: counts
    equal, points within 1e-5."""
    rgb, depth, K, P = synthetic_sequence(1, L, H, W, seed=0)
    jpc, _ = G.PointFusion(odom="gt", map_capacity=SCHEDULE, use_jit=True)(G.RGBDImages(
        jnp.asarray(rgb), jnp.asarray(depth), jnp.asarray(K), jnp.asarray(P)))
    with pytest.MonkeyPatch.context() as mp:
        emulate(mp)
        slam = PointFusion(odom="gt", map_capacity=SCHEDULE)
        slam(_frames())
        pc, _ = slam(_frames())
        assert slam.last_call_captured and slam.frame_graphs.replays > 0
    n = int(pc.num_points[0])
    assert n == int(jpc.num_points[0])
    np.testing.assert_allclose(pc.points[0, :n].numpy(), np.asarray(jpc.points)[0, :n],
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("cls", [PointFusion, ICPSLAM])
def test_on_the_cpu_use_jit_runs_eagerly_with_the_same_bits(cls):
    frames = _frames(L_=3)
    runs = []
    for flag in (True, False):
        slam = cls(odom="gt", use_jit=flag)
        runs.append(slam(frames))
        assert not slam.last_call_captured and len(slam.frame_graphs) == 0
    assert slam.last_eager_reason == "use_jit=False"
    jit = cls(odom="gt")
    jit(frames)
    assert jit.last_eager_reason == "inputs not on the card"
    assert _same(runs[0], runs[1])


def test_the_module_imports_neither_jax_nor_the_jax_package():
    import ast
    import inspect

    tree = ast.parse(inspect.getsource(graphs))
    names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    names |= {n.module or "" for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
    assert not any(n.split(".")[0] in ("jax", "gradslam_tpu") for n in names)


# ---------------------------------------------------------------------- #
# Gradients: forward and backward replayed (the capture emulated)
# ---------------------------------------------------------------------- #
GRAD_PIPELINES = {
    "gt": (PointFusion, dict(odom="gt")),
    "tracked": (PointFusion, TRACKED),
    "icpslam_aggregate": (ICPSLAM, dict(odom="icp", dsratio=4, numiters=3)),
}


def _grad_step(slam, arrays, depth_scale=1.0):
    """One gradient step of ``sum(points^2)`` (plus ``sum(t^2)`` of the
    poses for tracked runs) to the depths and the intrinsics:
    ``(pointclouds, poses, g_depth, g_K)``."""
    rgb, depth, K, P = (torch.from_numpy(np.asarray(a, np.float32)) for a in arrays)
    d = (depth * depth_scale).requires_grad_()
    k = K.clone().requires_grad_()
    pc, poses = slam(frames_of(rgb, d, k, P))
    loss = (pc.points ** 2).sum()
    if slam.odom != "gt":
        loss = loss + (poses[..., :3, 3] ** 2).sum()
    loss.backward()
    return pc, poses, d.grad, k.grad


def frames_of(rgb, depth, K, P):
    from gradslam_torch import RGBDImages
    return RGBDImages(rgb, depth, K, P)


def _same_grads(a, b) -> bool:
    """Forward and both gradients hold the same bits."""
    return (_same((a[0], a[1]), (b[0], b[1])) and torch.equal(a[2], b[2])
            and torch.equal(a[3], b[3]))


@pytest.mark.parametrize("remat", [False, True], ids=["remat_off", "remat_on"])
@pytest.mark.parametrize("name", sorted(GRAD_PIPELINES))
def test_captured_gradients_give_the_eager_bits(emulated, name, remat):
    """Three steps through one captured pipeline against ``use_jit=False``:
    the same map, poses and gradient bits. The first step warms up and
    captures each key's forward, the second each set of output gradients'
    backward, and the third replays every frame's forward and backward; a
    held step's results are unchanged by the next."""
    cls, kw = GRAD_PIPELINES[name]
    arrays = synthetic_sequence(1, L, H, W, seed=0)
    scales = (1.0, 1.01, 0.99)
    eager = cls(map_capacity=SCHEDULE, use_jit=False, remat=remat, **kw)
    want = [_grad_step(eager, arrays, s) for s in scales]
    assert eager.last_eager_reason == "use_jit=False"
    jit = cls(map_capacity=SCHEDULE, remat=remat, **kw)
    got = [_grad_step(jit, arrays, scales[0])]
    assert jit.last_call_captured and jit.last_eager_reason is None
    held = tuple(clone_tree(x) for x in got[0])
    got.append(_grad_step(jit, arrays, scales[1]))
    counts, replays = jit.frame_graphs.counts(), jit.frame_graphs.replays
    assert counts["backward"] >= len(SCHEDULE)
    if remat:  # the forward replays the no-grad frame graph
        assert counts["forward"] == 0 and counts["frame"] == len(SCHEDULE)
    else:
        assert counts["frame"] == 0 and counts["forward"] >= len(SCHEDULE)
    got.append(_grad_step(jit, arrays, scales[2]))
    assert jit.frame_graphs.counts() == counts  # nothing new captured
    assert jit.frame_graphs.replays - replays == 2 * (L - (kw["odom"] != "gt"))
    assert all(_same_grads(g, w) for g, w in zip(got, want))
    assert _same_grads(got[0], held)
    assert not torch.equal(got[0][2], got[1][2])


def _two_frames_one_key(fg, remat):
    """A two-frame recurrence whose frames share one key: frame 1's inputs
    and activations differ from frame 0's, so a backward that read the
    graph's last contents for frame 0 would be wrong."""
    torch.manual_seed(0)
    x = torch.randn(2, 3, 4, requires_grad=True)
    k = torch.randn(4, requires_grad=True)

    def body(state, xi, k):
        y = torch.sin(state * xi) * k + torch.tanh(state) * xi.exp()
        return y, (y * y).sum(dim=-1)

    s = torch.ones(3, 4).requires_grad_()
    outs = []
    for i in range(2):
        s, n = body(s, x[i], k) if fg is None else fg.grad("toy", body, (s, x[i], k),
                                                          remat=remat)
        outs.append(n)
    (outs[0].sum() + (s ** 2).sum()).backward()
    return x.grad, k.grad


@pytest.mark.parametrize("remat", [False, True], ids=["remat_off", "remat_on"])
def test_two_frames_through_one_key_keep_their_own_residuals(monkeypatch, remat):
    """Frames 0 and 1 through one key, twice (the second time both replay):
    the eager gradients. With the writes of each call's saved inputs,
    outputs and residuals back into the graph turned into no-ops, the
    backward reads the last frame's: the gradients differ (the trap)."""
    fake_cuda(monkeypatch)
    monkeypatch.setattr(FrameGraphs, "_graph", emulated_graph)
    want = _two_frames_one_key(None, remat)
    fg = FrameGraphs()
    for _ in range(2):
        got = _two_frames_one_key(fg, remat)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert fg.replays > 0
    real_backward = graphs._GradCall.backward

    def backward_without_write_back(self, *args):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(graphs, "_write", lambda dst, src: None)
            mp.setattr(graphs._Arena, "scatter", lambda self, arena: None)
            return real_backward(self, *args)

    monkeypatch.setattr(graphs._GradCall, "backward", backward_without_write_back)
    broken = _two_frames_one_key(fg, remat)
    assert not all(torch.equal(a, b) for a, b in zip(broken, want))


def test_the_arena_keeps_the_spans_the_saved_tensors_and_outputs_read():
    """An arena keeps, of each storage a saved tensor lives in, the bytes
    from a 16-byte boundary below its first read byte to its last (an
    output in that storage widens it); static inputs' storages stay out.
    A view of a gathered arena reads the tensor's bits, and a scatter
    writes them back."""
    static = torch.arange(8.0)
    big = torch.arange(100, dtype=torch.float32)
    part = big[40:50]  # bytes 160-200 of a 400-byte storage
    strided = torch.arange(60, dtype=torch.int64).view(6, 10)[1:4, ::3]
    out = big[52:54]  # an output beside the saved slice
    arena = graphs._Arena([static], [static[2:4], part, strided, part[1:3]], [out])
    assert len(arena.views) == 2 and arena.total == 64 + 240  # bytes 160-216, 80-320
    got = arena.gather(static.device)
    for t in (part, strided, out, part[1:3]):
        v = arena.view(got, t)
        assert v.dtype == t.dtype and v.stride() == t.stride() and torch.equal(v, t)
    assert arena.view(got, static) is None and arena.view(got, torch.ones(2)) is None
    big.zero_()
    arena.scatter(got)
    assert torch.equal(big[40:54], torch.arange(40, 54, dtype=torch.float32))
    assert torch.equal(big[:40], torch.zeros(40)) and torch.equal(big[56:], torch.zeros(44))


def test_an_in_place_edit_of_a_saved_output_raises_as_eagerly(monkeypatch):
    """Without ``remat`` an output that autograd saved (``exp``'s) is a view
    of the call's arena: an in-place edit of it before the backward raises,
    as it does eagerly, on the warm-up call and on replayed ones, instead
    of changing the residuals the backward reads."""
    fake_cuda(monkeypatch)
    monkeypatch.setattr(FrameGraphs, "_graph", emulated_graph)

    def body(x, k):
        y = torch.exp(x * k)
        return y, y.sum()

    fg = FrameGraphs()
    torch.manual_seed(0)
    for _ in range(3):
        x, k = torch.randn(5, requires_grad=True), torch.randn(5, requires_grad=True)
        for run in (body, lambda *a: fg.grad("toy", body, a)):
            y, _ = run(x, k)
            with pytest.raises(RuntimeError, match="modified by an inplace operation|"
                               "is a view and is being modified inplace"):
                y.mul_(2)
                y.sum().backward()
    assert fg.replays == 2 and fg.counts()["forward"] == 1


def test_refine_steps_replay_with_the_eager_bits(monkeypatch):
    """``refine()`` keeps one pipeline across its Adam steps: with the
    capture emulated its steady steps replay, and the losses and recovered
    calibration hold the CPU's eager bits."""
    from gradslam_torch.examples import gradient_refinement as example

    kw = dict(H=24, W=32, L=3, steps=3, lr=0.08, verbose=False, device="cpu")
    want = example.refine(**kw)
    made = []
    real_init = PointFusion.__init__

    def init(self, *a, **k):
        real_init(self, *a, **k)
        made.append(self)

    emulate(monkeypatch)
    monkeypatch.setattr(PointFusion, "__init__", init)
    got = example.refine(**kw)
    assert got == want
    (slam,) = made
    assert slam.last_call_captured and slam.frame_graphs.counts()["backward"] > 0
    assert slam.frame_graphs.replays >= 2 * 2 * (kw["L"] - 1)


@pytest.fixture(scope="module")
def grad_clip():
    from . import _gradparity as GP
    return GP, GP.clip()


@pytest.mark.parametrize("remat", [False, True], ids=["remat_off", "remat_on"])
@pytest.mark.parametrize("name,bar", [("gt", 1e-4), ("tracked", 1e-3)])
def test_captured_gradients_against_the_jax_packages_grad(grad_clip, name, bar, remat):
    """The emulated captured gradients against jitted ``jax.grad`` of the
    same loss on the same numpy clip, at the gradient tests' bars (1e-4 of
    max |g| gt, 1e-3 tracked: ``tests/port/test_torch_grad*.py``)."""
    GP, data = grad_clip
    kw = dict(odom="gt") if name == "gt" else dict(odom="gradicp", dsratio=2, numiters=3)
    tracked = name == "tracked"
    jd, jk = _jax_grads(GP, data, kw, tracked)
    with pytest.MonkeyPatch.context() as mp:
        emulate(mp)
        slam = PointFusion(remat=remat, **kw)
        for _ in range(2):  # the second step replays every frame
            pc, poses, gd, gk = _grad_step(slam, data[:4])
        assert slam.last_call_captured and slam.frame_graphs.replays > 0
    for got, want in ((gd, jd), (gk, jk)):
        scale = float(np.abs(want).max())
        assert scale > 0 and GP.max_gap(got.numpy(), want) <= bar * scale


_JAX_GRADS = {}


def _jax_grads(GP, data, kw, tracked):
    key = (tuple(sorted(kw.items())), tracked)
    if key not in _JAX_GRADS:
        _JAX_GRADS[key] = GP.jax_grads("PointFusion", kw, data, tracked)
    return _JAX_GRADS[key]
