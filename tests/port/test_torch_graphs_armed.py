"""Armed recovery (``relocalize_below > 0``, with and without
``anchor_every``) replayed as CUDA graphs, tested on the CPU with the
capture emulated as in ``test_torch_graphs.py`` (a stand-in graph whose
replay runs the body again into the same static outputs).

Each tracked frame is a gate graph, one read back of its flags, a graph
for each recovery branch where one is needed (keys ``'relocalize'`` and
``'anchor'``), and a fuse graph (``ICPSLAM._track``). Held here:

- The emulated armed ``forward`` gives the ``use_jit=False`` bits (poses
  and map), the same ``recovery_log`` (every gate reading, the branch
  frames) and the same launch counters (counted at the kernels'
  dispatchers), on the kidnapped clip of ``test_torch_recovery.py``
  (60x80x11, the 1-NN and the projective tracker: the relocalization runs
  on frame 8; and the 1-NN tracker with the anchor armed too, whose
  relocalization body runs the drift gate), and on its short anchored
  clip with ``anchor_below=1.0`` (the anchor re-solve runs on most
  frames). Every branch that runs goes through ``FrameGraphs`` under its
  key, once a branch frame, and the relocalization takes the grid's
  deltas as an input of its graph, made outside the capture.
- One host read (``icpslam._read_back``) on each tracked frame where no
  branch runs; after a relocalization an anchored frame reads once more.
- The anchor, which the gate passes through, comes back to the gate's own
  static inputs on a frame that does not refresh it (and is not copied
  onto itself there).
- Armed on a clean clip, the captured run is the unarmed captured run.
- Under grad, with ``remat`` on and off, the captured armed gradients to
  the depth and the intrinsics are eager's bits over two steps, on the
  kidnap (projective tracker) and on the anchored clip.
- Over two capacity segments, the health readings the log keeps outlive
  the branch graphs' replays (the emulation poisons a later graph's
  memory on an earlier graph's replay, as the shared pool does).
- The emulated armed run against the JAX package's jitted armed
  ``forward`` (the 1-NN row, and with the anchor armed too): poses within
  1e-4, each gate reading within 1/N, the same relocalization frames and
  the same anchor re-solve frames.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import collections  # noqa: E402

import gradslam_torch as T  # noqa: E402
from gradslam_torch.ops import knn_cuda, scatter_cuda  # noqa: E402
from gradslam_torch.slam import icpslam as icpslam_module  # noqa: E402
from gradslam_torch.slam.relocalize import _compose_grid  # noqa: E402
from gradslam_torch.utils import graphs as graphs_module  # noqa: E402
from gradslam_torch.utils.graphs import FrameGraphs, clone_tree  # noqa: E402

from . import test_torch_recovery as R  # noqa: E402
from ._parity import both_frames  # noqa: E402
from ._graph_emulation import count_at_dispatchers, emulate  # noqa: E402
from .test_torch_graphs import _grad_step, _same, _same_grads  # noqa: E402

@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module: its pipelines are thousands of
    small ops, which more threads do not speed up (the module takes the
    same time on one), while threads that spin slow the suite's other
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


KIDNAP = dict(odom="gradicp", dsratio=4, numiters=10, map_capacity=R.L * R.H * R.W, **R.TUNED)
ANCHORED = dict(odom="gradicp", odom_assoc="projective", dsratio=4, numiters=6,
                motion_model="constant_velocity", odom_angle_gate=60.0,
                map_capacity=7 * R.H * R.W, relocalize_below=0.2, anchor_every=3,
                anchor_below=1.0, **R.TUNED)
CLEAN = dict(odom="gradicp", odom_assoc="projective", odom_sym_normals=True, dsratio=2,
             numiters=8, map_capacity=8 * R.H * R.W)


def kidnap_arrays():
    rgb, d, K, poses = T.synthetic_sequence(R.B, 12, R.H, R.W, speed=8.0)
    jump = tuple(float(x) for x in poses[0, 0, :3, 3] - poses[0, 7, :3, 3])
    return (rgb[:, R.ORDER], d[:, R.ORDER], K, poses[:, R.ORDER]), jump


def rows() -> dict:
    """Each armed row: ``(arrays, options)``. ``knn_anchor`` is the 1-NN
    kidnap with the anchor armed too: its relocalization (frame 8) runs the
    drift gate in its body, and the host reads that gate's flags once
    more."""
    arrays, jump = kidnap_arrays()
    out = {name: (arrays, dict(KIDNAP, **row)) for name, row in R.rows(jump).items()}
    out["knn_anchor"] = (arrays, dict(out["knn"][1], anchor_every=3))
    out["anchored"] = (T.hard_sequence(1, 7, R.H, R.W, outlier_frac=0.0), ANCHORED)
    return out


def spy_on_frame_graphs(mp) -> collections.Counter:
    """The names of the bodies run through ``FrameGraphs``, no-grad
    (``__call__``) and under autograd (``grad``), counted by
    ``(method, name)``."""
    calls = collections.Counter()
    for method in ("__call__", "grad"):
        def spy(self, name, *args, _real=getattr(FrameGraphs, method), _method=method,
                **kwargs):
            calls[_method, name] += 1
            return _real(self, name, *args, **kwargs)

        mp.setattr(FrameGraphs, method, spy)
    return calls


class Counted:
    """Both kernels' launch counters raised at their dispatchers (on the
    CPU no wrapper launches), and the host reads of each tracked frame."""

    def __init__(self, mp):
        self.reads = {}
        self.frame = None
        count_at_dispatchers(mp)
        real_read = icpslam_module._read_back

        def read_back(flags):
            self.reads[self.frame] = self.reads.get(self.frame, 0) + 1
            return real_read(flags)

        mp.setattr(icpslam_module, "_read_back", read_back)
        real_track = T.ICPSLAM._track

        def track(slam, map_pc, prev_pose, prev_delta, anchor, f, *args, **kwargs):
            self.frame = f
            return real_track(slam, map_pc, prev_pose, prev_delta, anchor, f, *args, **kwargs)

        mp.setattr(T.ICPSLAM, "_track", track)

    def run(self, slam, frames):
        knn_cuda.launches = scatter_cuda.launches = 0
        self.reads = {}
        out = slam(frames)
        return out, (knn_cuda.launches, scatter_cuda.launches), dict(self.reads)


_RUNS = {}


def armed_runs(name: str) -> dict:
    """The row run with ``use_jit=False`` and then twice captured (the
    capture emulated; the first call warms up and captures, the second
    replays every frame): each run's ``(result, launches, reads by frame,
    recovery_log)``, the captured pipeline's graph counts, whether its
    calls were captured, the static inputs that the replayed call gave
    back to their own graph (``self_writes``), the bodies each captured call
    ran through ``FrameGraphs`` by name (``<call>_names``), its
    ``by_key`` tallies after each call (``<call>_by_key``) and the
    relocalization's pose and grid deltas as its body received them in
    each call (``<call>_grid``). Made once a row."""
    if name in _RUNS:
        return _RUNS[name]
    arrays, kw = rows()[name]
    _, frames = both_frames(*arrays)
    got = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(knn_cuda, "launches", 0)
        mp.setattr(scatter_cuda, "launches", 0)
        counted = Counted(mp)
        eager = T.PointFusion(use_jit=False, **kw)
        got["eager"] = (*counted.run(eager, frames), eager.recovery_log)
        emulate(mp)
        real_write, self_writes = graphs_module._write, []

        def write(dst, src):
            self_writes.append(dst is src)
            real_write(dst, src)

        mp.setattr(graphs_module, "_write", write)
        names = spy_on_frame_graphs(mp)
        grid = []
        real_relocalize = T.ICPSLAM._relocalize

        def relocalize(slam, map_pc, live, poses, inlier, deltas, anchor=None):
            grid.append((poses.clone(), deltas))
            return real_relocalize(slam, map_pc, live, poses, inlier, deltas, anchor)

        mp.setattr(T.ICPSLAM, "_relocalize", relocalize)
        jit = T.PointFusion(**kw)
        for call in ("first", "replayed"):
            self_writes.clear()
            names.clear()
            grid.clear()
            out = counted.run(jit, frames)
            got[call] = (clone_tree(out[0]), *out[1:], jit.recovery_log)
            got[f"{call}_captured"] = jit.last_call_captured
            got[f"{call}_names"] = {name: n for (_, name), n in names.items()}
            got[f"{call}_grid"] = list(grid)
            got[f"{call}_by_key"] = {k: dict(t) for k, t in jit.frame_graphs.by_key.items()}
        got["self_writes"] = sum(self_writes)
        got["graphs"] = jit.frame_graphs.counts()
        got["keys"] = sorted({key[0] for key in jit.frame_graphs._entries})
        got["static_in"] = {key[0]: entry.static_in
                            for key, entry in jit.frame_graphs._entries.items()}
        got["relocalize_grid"] = jit.relocalize_grid
    _RUNS[name] = got
    return got


def _same_log(a, b) -> bool:
    return (a["relocalize"] == b["relocalize"] and a["anchor"] == b["anchor"]
            and len(a["health"]) == len(b["health"])
            and all(torch.equal(x, y) for x, y in zip(a["health"], b["health"])))


BRANCHES = ("relocalize", "anchor")
# the branches each row runs: the kidnap rows relocalize (frame 8), the
# anchored clip re-solves against its anchor
ROW_BRANCHES = {"knn": ("relocalize",), "projective": ("relocalize",),
                "knn_anchor": ("relocalize",), "anchored": ("anchor",)}


@pytest.mark.parametrize("name", ["knn", "projective", "knn_anchor", "anchored"])
def test_armed_forward_captured_gives_the_eager_bits(name):
    """The emulated captured run, first and replayed call, against
    ``use_jit=False``: the same poses and map bits, gate readings and
    branch frames, and the same launch counters; each call captured, with
    a gate and a fuse graph and a graph for each branch that ran (keys
    ``'relocalize'``, ``'anchor'``), the branch run through
    ``FrameGraphs`` once on each of its frames (the first call warms up
    and captures it, the second replays it)."""
    runs = armed_runs(name)
    want, want_launches, _, want_log = runs["eager"]
    assert want_log["relocalize"] == ([8] if name != "anchored" else want_log["relocalize"])
    if name == "anchored":
        assert len(want_log["anchor"]) >= 3
    ran = {k for k in BRANCHES if want_log[k]}
    assert set(ROW_BRANCHES[name]) <= ran
    for call in ("first", "replayed"):
        out, launches, _, log = runs[call]
        assert runs[f"{call}_captured"]
        assert _same(out, want), call
        assert _same_log(log, want_log), call
        assert launches == want_launches, call
        assert {k: runs[f"{call}_names"].get(k, 0) for k in BRANCHES} == {
            k: len(want_log[k]) for k in BRANCHES}, call
    assert runs["keys"] == sorted({"fuse", "gate"} | ran)
    assert runs["graphs"]["frame"] >= 2 + len(ran)
    first, replayed = runs["first_by_key"], runs["replayed_by_key"]
    assert sorted(first) == sorted(replayed) == runs["keys"]
    for k in ran:  # each branch graph captured once, then replayed once a branch frame
        assert first[k]["frame"] == replayed[k]["frame"] == 1
        assert replayed[k]["replays"] - first[k].get("replays", 0) == len(want_log[k])


@pytest.mark.parametrize("name", ["knn", "knn_anchor"])
def test_the_relocalization_takes_the_grid_deltas_as_an_input(name):
    """The relocalization's graph composes its hypotheses from the grid's
    deltas ``(K, 4, 4)`` given as a tensor input, one of the graph's static
    inputs (a copy from the host may not be captured): made once by the
    pipeline, outside the capture, and equal to ``perturbation_grid``'s
    deltas, so the grid around the gate's pose is ``perturbation_grid``'s
    bit for bit."""
    runs = armed_runs(name)
    grid = runs["relocalize_grid"]
    K = len(grid["yaw_deg"]) * len(grid["translations"])
    static = runs["static_in"]["relocalize"]
    for call in ("first", "replayed"):
        seen = runs[f"{call}_grid"]
        assert len(seen) == (2 if call == "first" else 1)  # the warm-up and the capture
        for poses, deltas in seen:
            assert isinstance(deltas, torch.Tensor) and deltas.shape == (K, 4, 4)
            assert any(deltas is t for t in static)
            eye = torch.eye(4, dtype=deltas.dtype)[None]
            assert torch.equal(T.perturbation_grid(eye, **grid)[0], deltas)
            assert torch.equal(_compose_grid(poses[:, 0], deltas),
                               T.perturbation_grid(poses[:, 0], **grid))


@pytest.mark.parametrize("name", ["knn", "projective", "knn_anchor", "anchored"])
def test_one_read_back_a_frame_where_no_branch_runs(name):
    """Each tracked frame reads its gate's flags back once; a frame where
    the relocalization ran with the anchor armed reads the anchor's gate
    once more. Eager and captured read alike."""
    runs = armed_runs(name)
    _, _, _, log = runs["eager"]
    L = len(log["health"]) + 1
    anchored = "anchor_every" in rows()[name][1]
    want = {f: 1 + (anchored and f in log["relocalize"]) for f in range(1, L)}
    branch_free = [f for f in range(1, L) if f not in log["relocalize"] + log["anchor"]]
    assert branch_free and all(want[f] == 1 for f in branch_free)
    for call in ("eager", "first", "replayed"):
        assert runs[call][2] == want, call


@pytest.mark.parametrize("name", ["knn", "anchored"])
def test_an_input_passed_through_comes_back_to_its_own_graph(name):
    """The gate returns the anchor as it came, and a frame that does not
    refresh the anchor gives it to the next frame's gate: a static input
    given back to its own graph, which ``graphs._write`` leaves alone
    rather than copying it onto itself. The map comes back through the
    fuse graph's outputs, so without the anchor nothing does."""
    same = armed_runs(name)["self_writes"]
    if name == "anchored":
        assert same > 0 and same % 3 == 0  # the anchor's points, normals, counts
    else:
        assert same == 0


def test_the_health_log_outlives_the_branch_graphs(monkeypatch):
    """The anchored clip over two capacity segments, captured (the second
    call replays every frame) against ``use_jit=False``: the anchor
    re-solve's key holds no map, so its graph, captured in the first
    segment, replays between the second segment's gate (captured later, in
    the pool the anchor's graph scratches in) and the fuse. The health
    readings the log keeps, and the poses and map, are eager's bits."""
    arrays, kw = rows()["anchored"]
    kw = dict(kw, map_capacity=[(4, 4 * R.H * R.W), (3, 7 * R.H * R.W)])
    _, frames = both_frames(*arrays)
    eager = T.PointFusion(use_jit=False, **kw)
    want = eager(frames)
    emulate(monkeypatch)
    jit = T.PointFusion(**kw)
    for _ in range(2):
        got = jit(frames)
        assert jit.last_call_captured
        assert _same(got, want)
        assert _same_log(jit.recovery_log, eager.recovery_log)
    segment = {kind: [f for f in eager.recovery_log[kind] if f >= 4] for kind in BRANCHES}
    assert segment["anchor"], segment  # the anchor's graph replays in the second segment
    assert len({key[1:] for key in jit.frame_graphs._entries if key[0] == "gate"}) == 2


@pytest.mark.parametrize("armed", [
    dict(relocalize_below=0.2),
    dict(relocalize_below=0.2, anchor_every=3),
], ids=["relocalize", "relocalize_anchor"])
def test_armed_clean_clip_captured_is_the_unarmed_captured_run(monkeypatch, armed):
    """On a clean clip nothing trips: the captured armed run (second call,
    every frame replayed) gives the captured unarmed run's bits, reads back
    once a frame and runs no branch."""
    rgb, d, K, poses = T.synthetic_sequence(1, 8, R.H, R.W)
    _, frames = both_frames(rgb, d, K, poses)
    counted = Counted(monkeypatch)
    emulate(monkeypatch)
    base = T.PointFusion(**CLEAN)
    base(frames)
    want = clone_tree(base(frames))
    slam = T.PointFusion(**CLEAN, **armed)
    slam(frames)
    got, _, reads = counted.run(slam, frames)
    assert slam.last_call_captured and base.last_call_captured
    assert _same(got, want)
    assert slam.recovery_log["relocalize"] == slam.recovery_log["anchor"] == []
    assert reads == {f: 1 for f in range(1, 8)}


def _kidnap_grad_arrays():
    """The kidnap cut after the kidnapped frame (as ``test_torch_recovery``'s
    remat test), float32."""
    (rgb, depth, K, P), jump = kidnap_arrays()
    return (rgb[:, :9], depth[:, :9], K, P[:, :9]), jump


GRAD_SCALES = (1.0, 1.01)  # the depth scale of each gradient step
_EAGER_GRADS = {}


def _branches(slam) -> dict:
    return {k: slam.recovery_log[k] for k in ("relocalize", "anchor")}


def eager_grad_steps(name: str) -> tuple:
    """``(arrays, options, steps, branch frames of each step)``: the
    gradient steps of row ``name`` with ``use_jit=False``, made once a
    row."""
    if name not in _EAGER_GRADS:
        cut = dict(numiters=3, relocalize_numiters=4)
        if name == "anchored":
            arrays, kw = rows()["anchored"]
            kw = dict(kw, **cut)
        else:
            arrays, jump = _kidnap_grad_arrays()
            kw = dict(KIDNAP, map_capacity=9 * R.H * R.W, **R.rows(jump)["projective"], **cut)
        eager = T.PointFusion(use_jit=False, **kw)
        steps, ran = [], []
        for s in GRAD_SCALES:
            steps.append(_grad_step(eager, arrays, s))
            ran.append(_branches(eager))
        _EAGER_GRADS[name] = arrays, kw, steps, ran
    arrays, kw, steps, ran = _EAGER_GRADS[name]
    for r in ran:
        assert r["relocalize"] == [8] if name != "anchored" else len(r["anchor"]) >= 3
    return _EAGER_GRADS[name]


@pytest.mark.parametrize("name,remat", [
    ("projective", False), ("projective", True), ("anchored", True),
], ids=["projective-remat_off", "projective-remat_on", "anchored-remat_on"])
def test_armed_captured_gradients_give_the_eager_bits(monkeypatch, name, remat):
    """Two gradient steps captured against ``use_jit=False`` (remat off:
    eagerly remat on gives its bits, ``test_torch_recovery.py``): the
    same map, poses and gradient bits to the depth and the intrinsics, and
    the same branch frames in every step, each branch run through
    ``FrameGraphs.grad`` on each of its frames (its forward and backward
    replayed from graphs of its own; eagerly its inputs that need a
    gradient go through one view). The projective tracker armed on the
    kidnap (cut after the kidnapped frame) relocalizes on frame 8; the
    anchored clip re-solves against its anchor on most frames, with
    refreshes. Three iterations a solve and four a recovery solve: the
    bits, not the recovery, are under test."""
    arrays, kw, want, ran = eager_grad_steps(name)
    emulate(monkeypatch)
    names = spy_on_frame_graphs(monkeypatch)
    jit = T.PointFusion(remat=remat, **kw)
    got = []
    for s, r in zip(GRAD_SCALES, ran):
        names.clear()
        got.append(_grad_step(jit, arrays, s))
        assert jit.last_call_captured and _branches(jit) == r
        assert {k: names["grad", k] for k in BRANCHES} == {k: len(r[k]) for k in BRANCHES}
        assert all(names["grad", k] for k in ROW_BRANCHES[name])
    assert jit.frame_graphs.counts()["backward"] >= 2 and jit.frame_graphs.replays > 0
    assert all(_same_grads(g, w) for g, w in zip(got, want))
    assert bool(torch.isfinite(got[1][2]).all()) and not torch.equal(got[0][2], got[1][2])


def jax_drift_frames(mp) -> list:
    """Records, for each tracked frame of the JAX package's next anchored
    run, whether its drift gate flagged a sequence (``drifting``, read
    through a ``jax.debug.callback`` on ``ICPSLAM._maybe_anchor_recover``,
    which runs on the pose the relocalization returns); the list fills as
    the run goes."""
    drift = []
    real = R.JaxICPSLAM._maybe_anchor_recover

    def recorded(self, anchor, live, poses):
        poses, drifting = real(self, anchor, live, poses)
        jax.debug.callback(lambda x: drift.append(bool(np.asarray(x).any())), drifting,
                           ordered=True)
        return poses, drifting

    mp.setattr(R.JaxICPSLAM, "_maybe_anchor_recover", recorded)
    return drift


@pytest.mark.parametrize("name", ["knn", "knn_anchor"])
def test_armed_capture_against_the_jax_packages_jit(monkeypatch, name):
    """The emulated captured armed run of the 1-NN row (every frame
    replayed), and of the 1-NN row with the anchor armed too, against the
    JAX package's jitted armed ``forward`` on the same clip: poses within
    1e-4, each gate reading within 1/N (N the rows scored, at least 300),
    the relocalization on the same frames, and the anchor re-solve on the
    frames where JAX's drift gate flagged a sequence (on the anchored row
    the drift gate runs in the relocalization's body, on the pose it
    leaves: run on the pose before it, the gate re-solves frame 8 and the
    poses move by about 2 mm). (The projective row is held to
    ``use_jit=False``'s bits above, and that to JAX in
    ``test_torch_recovery.py``.)"""
    arrays, kw = rows()[name]
    drift = jax_drift_frames(monkeypatch)
    _, jposes, readings = R.jax_run(monkeypatch, arrays, kw)
    runs = armed_runs(name)
    (_, poses), _, _, log = runs["replayed"]
    np.testing.assert_allclose(poses.numpy(), jposes, atol=1e-4, rtol=0)
    ours = torch.stack(log["health"]).numpy()
    assert ours.shape == readings.shape == (R.L - 1, R.B)
    np.testing.assert_allclose(ours, readings, atol=1.0 / 300 + 1e-7, rtol=0)
    jax_frames = [f + 1 for f in range(R.L - 1) if (readings[f] < 0.5).any()]
    assert log["relocalize"] == jax_frames == [8]
    assert len(drift) == (R.L - 1 if "anchor_every" in kw else 0)
    assert log["anchor"] == [f + 1 for f, d in enumerate(drift) if d]
