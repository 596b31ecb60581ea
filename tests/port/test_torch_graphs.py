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
"""

import contextlib
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import gradslam_tpu as G  # noqa: E402
from gradslam_torch import ICPSLAM, Pointclouds, PointFusion  # noqa: E402
from gradslam_torch.interop import rgbdimages_from_numpy  # noqa: E402
from gradslam_torch.ops import knn_cuda, scatter_cuda  # noqa: E402
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
@pytest.mark.parametrize("use_jit,on_card,grad,armed,want", [
    (True, True, False, False, None),
    (False, True, False, False, "use_jit=False"),
    (True, False, False, False, "inputs not on the card"),
    (True, True, True, False, "an input needs a gradient"),
    (True, True, False, True, "recovery armed (relocalize_below > 0)"),
    (False, False, True, True, "use_jit=False"),
])
def test_eager_reason(use_jit, on_card, grad, armed, want):
    assert eager_reason(use_jit, on_card, grad, armed) == want


def test_eager_reason_reads_the_tensors():
    frames = _frames(L_=2)
    assert eager_reason_for(True, frames) == "inputs not on the card"
    depth = frames.depth_image.clone().requires_grad_()
    # on a (pretended) card, a gradient input keeps the call eager only in grad mode
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
        assert eager_reason_for(True, frames) is None
        assert eager_reason_for(True, frames, armed=True).startswith("recovery armed")
        assert eager_reason_for(True, depth) == "an input needs a gradient"
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
class _StandInGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


@pytest.fixture
def counters(monkeypatch):
    monkeypatch.setattr(knn_cuda, "launches", 0)
    monkeypatch.setattr(scatter_cuda, "launches", 0)


def test_a_replay_adds_the_launches_its_capture_recorded(counters):
    static_in, static_out = [torch.zeros(3)], [torch.ones(2)]
    call = CapturedCall(_StandInGraph(), static_in, static_out, flatten(torch.ones(2))[1], (2, 3))
    src = torch.arange(3.0)
    for n in (1, 2, 3):
        out = call([src])
        assert (knn_cuda.launches, scatter_cuda.launches) == (2 * n, 3 * n)
        assert call.graph.replays == n and out is static_out[0]
        assert torch.equal(static_in[0], src)


def _fake_cuda(monkeypatch, graph_cls=_StandInGraph):
    """torch.cuda's capture calls as stand-ins that run on the CPU."""
    stream = types.SimpleNamespace(wait_stream=lambda other: None)
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: stream)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: stream)
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: object())
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: 0)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", lambda mode: None)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", graph_cls)
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda g, pool=None, stream=None: contextlib.nullcontext())


def _body(x):
    """Stands in for a frame body: two 1-NN and one scatter launch."""
    knn_cuda.launches += 2
    scatter_cuda.launches += 1
    return x + 1


def test_capture_takes_back_its_increments_and_replays_add_them(monkeypatch, counters):
    _fake_cuda(monkeypatch)
    cache = FrameGraphs()
    x = torch.zeros(4)
    first = cache("body", _body, (x,))
    assert torch.equal(first, x + 1)  # the warm-up's result
    assert (knn_cuda.launches, scatter_cuda.launches) == (2, 1)  # the warm-up only
    assert len(cache) == 1 and cache.capture_s >= 0.0
    for n in (1, 2):
        cache("body", _body, (x,))
        assert (knn_cuda.launches, scatter_cuda.launches) == (2 + 2 * n, 1 + n)
    cache("body", _body, (torch.zeros(5),))  # a new shape: warm-up and capture again
    assert len(cache) == 2 and (knn_cuda.launches, scatter_cuda.launches) == (8, 4)
    cache.clear()
    assert len(cache) == 0 and cache._pool is None


def test_a_failed_capture_raises_and_stores_nothing(monkeypatch, counters):
    _fake_cuda(monkeypatch)
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


# ---------------------------------------------------------------------- #
# The pipelines, with the capture emulated on the CPU
# ---------------------------------------------------------------------- #
def _emulated_capture(self, key, fn, leaves, spec):
    """FrameGraphs._capture on the CPU: the warm-up is the result; the
    graph's replay runs the body again on the static inputs and writes into
    the static outputs the capture returned, as a replay does."""
    static_in = [t.clone() for t in leaves]
    result = fn(*unflatten(spec, static_in))
    static_out, out_spec = flatten(fn(*unflatten(spec, static_in)))
    outer = self

    class Replay:
        def replay(self):
            outer.replays += 1
            fresh, _ = flatten(fn(*unflatten(spec, static_in)))
            for dst, src in zip(static_out, fresh):
                dst.copy_(src)

    self._entries[key] = CapturedCall(Replay(), static_in, static_out, out_spec, (0, 0))
    return result


@pytest.fixture
def emulated(monkeypatch):
    """Calls on CPU tensors taken as on the card, the capture emulated."""
    monkeypatch.setattr(FrameGraphs, "_capture", _emulated_capture)
    monkeypatch.setattr(FrameGraphs, "replays", 0, raising=False)

    def on_card(use_jit, *trees, armed=False):
        needs_grad = torch.is_grad_enabled() and any(
            t.requires_grad for tree in trees for t in flatten(tree)[0])
        return eager_reason(use_jit, True, needs_grad, armed)

    monkeypatch.setattr(icpslam_module, "eager_reason_for", on_card)


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
    frames = _frames(L_=3)
    depth = frames.depth_image.clone().requires_grad_()
    slam = PointFusion(odom="gt")
    pc, _ = slam(frames.__class__(frames.rgb_image, depth, frames.intrinsics, frames.poses))
    assert not slam.last_call_captured and slam.last_eager_reason == "an input needs a gradient"
    pc.points.sum().backward()
    assert depth.grad is not None and len(slam.frame_graphs) == 0
    armed = PointFusion(odom="gradicp", dsratio=4, numiters=2, relocalize_below=0.2)
    armed(frames)
    assert not armed.last_call_captured and armed.last_eager_reason.startswith("recovery armed")
    assert len(armed.frame_graphs) == 0


def test_emulated_capture_against_the_jax_packages_jit():
    """The slice as a whole: the gt forward with its frames replayed (the
    capture emulated) against ``jax.jit``'s, on the same arrays: counts
    equal, points within 1e-5."""
    rgb, depth, K, P = synthetic_sequence(1, L, H, W, seed=0)
    jpc, _ = G.PointFusion(odom="gt", map_capacity=SCHEDULE, use_jit=True)(G.RGBDImages(
        jnp.asarray(rgb), jnp.asarray(depth), jnp.asarray(K), jnp.asarray(P)))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(FrameGraphs, "_capture", _emulated_capture)
        mp.setattr(FrameGraphs, "replays", 0, raising=False)
        mp.setattr(icpslam_module, "eager_reason_for",
                   lambda use_jit, *trees, armed=False: eager_reason(use_jit, True, False, armed))
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
