"""Armed recovery (``relocalize_below > 0``, with and without
``anchor_every``) replayed as CUDA graphs, tested on the CPU with the
capture emulated as in ``test_torch_graphs.py`` (a stand-in graph whose
replay runs the body again into the same static outputs, and a stand-in
conditional node, ``tests/port/_graph_emulation.py``).

Without grad each tracked frame is one graph (key ``'armed'``,
``ICPSLAM._armed``) whose recovery branches are conditional nodes
(``graphs.when``) decided on the device, as JAX's ``lax.cond``; so it is
under autograd, with remat or without (one ``FrameGraphs.grad`` call a
frame, ``test_torch_graphs_armed_grad.py`` and
``test_torch_graphs_armed_grad_nomat.py``). Eagerly a frame is a gate
body, one read back of its flags, a body for each recovery branch where
one is needed, and a fuse body (``ICPSLAM._track``). Held here:

- The emulated armed ``forward`` gives the ``use_jit=False`` bits (poses
  and map), the same ``recovery_log`` (every gate reading, the branch
  frames) and the same launch counters (counted at the kernels'
  dispatchers), on the kidnapped clip of ``test_torch_recovery.py``
  (60x80x11, the 1-NN and the projective tracker: the relocalization runs
  on frame 8; and the 1-NN tracker with the anchor armed too, whose
  relocalization body runs the drift gate), and on its short anchored
  clip with ``anchor_below=1.0`` (the anchor re-solve runs on most
  frames, refresh frames among them, where the refresh's conditional is
  false). Each branch is a conditional of the one frame graph, its
  launches added where its predicate read true, and the relocalization
  takes the grid's deltas as an input of that graph, made outside the
  capture.
- Eagerly one host read (``icpslam._read_back``) on each tracked frame
  where no branch runs, and after a relocalization an anchored frame reads
  once more; captured without grad, one read a run, after the last frame
  (under grad, one more after the backward's last frame).
- The anchor, which the gate passes through, comes back to the frame
  graph's own static inputs on a frame that does not refresh it (and is
  not copied onto itself there); so does the motion without the
  constant-velocity model.
- Armed on a clean clip, the captured run is the unarmed captured run.
- Under grad, with ``remat`` on and off (one ``'armed'`` call a frame, two
  reads a step; without remat the first step grows the branches' stores
  and runs its forward twice), the captured armed gradients to the depth
  and the intrinsics are eager's bits over two steps, on the kidnap
  (projective tracker) and on the anchored clip.
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

from ._threads import one_thread  # noqa: E402,F401


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
    CPU no wrapper launches), and the host reads by tracked frame: the
    frame whose gate reading the log would keep next (``L`` after the last
    tracked frame)."""

    def __init__(self, mp):
        self.reads = {}
        self.slam = None
        count_at_dispatchers(mp)
        real_read = icpslam_module._read_back

        def read_back(flags):
            frame = None if self.slam is None else len(self.slam.recovery_log["health"]) + 1
            self.reads[frame] = self.reads.get(frame, 0) + 1
            return real_read(flags)

        mp.setattr(icpslam_module, "_read_back", read_back)

    def run(self, slam, frames):
        knn_cuda.launches = scatter_cuda.launches = 0
        self.reads, self.slam = {}, slam
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
    ``by_key`` tallies after each call (``<call>_by_key``), the
    relocalization's pose and grid deltas as its body received them in
    each call (``<call>_grid``), the predicates ``settle`` read in each
    call (``<call>_took``) and the launches it added for the conditional
    bodies that ran (``<call>_branch_launches``), and each captured frame
    graph's conditionals: by its options, what each conditional's body
    counted (``conditionals``). Made once a row."""
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
        took = []
        real_settle = FrameGraphs.settle

        def settle(self, *args, **kwargs):
            result = real_settle(self, *args, **kwargs)
            took.extend(result)
            return result

        mp.setattr(FrameGraphs, "settle", settle)
        jit = T.PointFusion(**kw)
        for call in ("first", "replayed"):
            self_writes.clear()
            names.clear()
            grid.clear()
            took.clear()
            settled = collections.Counter(jit.frame_graphs.branch_launches)
            out = counted.run(jit, frames)
            got[f"{call}_branch_launches"] = jit.frame_graphs.branch_launches - settled
            got[call] = (clone_tree(out[0]), *out[1:], jit.recovery_log)
            got[f"{call}_captured"] = jit.last_call_captured
            got[f"{call}_names"] = {name: n for (_, name), n in names.items()}
            got[f"{call}_grid"] = list(grid)
            got[f"{call}_by_key"] = {k: dict(t) for k, t in jit.frame_graphs.by_key.items()}
            got[f"{call}_took"] = list(took)
        got["self_writes"] = sum(self_writes)
        got["graphs"] = jit.frame_graphs.counts()
        got["keys"] = sorted({key[0] for key in jit.frame_graphs._entries})
        got["static_in"] = collections.defaultdict(list)  # of every graph of a key name
        for key, entry in jit.frame_graphs._entries.items():
            got["static_in"][key[0]] += entry.static_in
        got["conditionals"] = {key[1]: entry.branch_counts
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
    branch frames, and the same launch counters; each call captured, every
    tracked frame through one ``FrameGraphs`` call of the key ``'armed'``
    (one graph for each set of options: a refresh frame has its own),
    captured in the first call and replayed on every frame of the
    second, and no branch run through ``FrameGraphs`` on its own."""
    runs = armed_runs(name)
    want, want_launches, _, want_log = runs["eager"]
    assert want_log["relocalize"] == ([8] if name != "anchored" else want_log["relocalize"])
    if name == "anchored":
        assert len(want_log["anchor"]) >= 3
    ran = {k for k in BRANCHES if want_log[k]}
    assert set(ROW_BRANCHES[name]) <= ran
    tracked = len(want_log["health"])
    for call in ("first", "replayed"):
        out, launches, _, log = runs[call]
        assert runs[f"{call}_captured"]
        assert _same(out, want), call
        assert _same_log(log, want_log), call
        assert launches == want_launches, call
        assert runs[f"{call}_names"] == {"armed": tracked}, call
    assert runs["keys"] == ["armed"]
    first, replayed = runs["first_by_key"], runs["replayed_by_key"]
    graphs = len(runs["conditionals"])
    assert graphs == (2 if "anchor_every" in rows()[name][1] else 1)
    assert runs["graphs"]["frame"] == first["armed"]["frame"] == replayed["armed"]["frame"] == graphs
    assert first["armed"]["replays"] == tracked - graphs
    assert replayed["armed"]["replays"] - first["armed"]["replays"] == tracked


@pytest.mark.parametrize("name", ["knn", "projective", "knn_anchor", "anchored"])
def test_armed_branches_are_conditionals_of_the_frame_graph(name):
    """Each recovery branch is a conditional of the one frame graph, in the
    JAX body's order: the relocalization (with the anchor, the drift gate
    in its body), the anchor re-solve, and on a refresh frame the anchor's
    refresh. Its launches, counted apart from the graph's, are added only
    on the frames whose predicate ``settle`` read true (in one read a
    run): the relocalization's 1-NN searches and scatters, the re-solve's
    searches, the refresh's snapshot compactions; ``branch_launches``
    tallies what ``settle`` added. The predicates read are the eager run's
    branch frames."""
    runs = armed_runs(name)
    _, _, _, want_log = runs["eager"]
    anchored = "anchor_every" in rows()[name][1]
    every = rows()[name][1].get("anchor_every", 0)
    for options, counts in runs["conditionals"].items():
        cv, refresh, has_anchor = options
        assert has_anchor == anchored
        assert len(counts) == 1 + anchored + (anchored and refresh)
        reloc = counts[0]
        assert reloc[(knn_cuda.__name__, None)] > 0 and reloc[(scatter_cuda.__name__, None)] > 0
        if anchored:
            assert set(counts[1]) == {(knn_cuda.__name__, None), (scatter_cuda.__name__, None)}
        if anchored and refresh:
            assert set(counts[2]) == {(scatter_cuda.__name__, None)}
    for call in ("first", "replayed"):
        took = runs[f"{call}_took"]
        frames = range(1, len(want_log["health"]) + 1)
        assert len(took) == len(frames)
        added = collections.Counter()
        for f, ran in zip(frames, took):
            options = next(o for o in runs["conditionals"] if o[1] == bool(every and f % every == 0))
            for r, counts in zip(ran, runs["conditionals"][options]):
                if r:
                    added.update(counts)
        assert runs[f"{call}_branch_launches"] == added
        assert [f for f, t in zip(frames, took) if t[0]] == want_log["relocalize"]
        if anchored:
            assert [f for f, t in zip(frames, took) if t[1]] == want_log["anchor"]
            assert [len(t) for t in took] == [3 if f % every == 0 else 2 for f in frames]


def test_a_refresh_frame_where_every_sequence_drifts():
    """The anchored clip has refresh frames (``f % anchor_every == 0``)
    where its one sequence drifts: there the refresh's conditional reads
    false and the anchor is kept, and on another refresh frame it reads
    true; the captured run is eager's bits throughout (the anchor carries
    on to the later frames' drift gates)."""
    runs = armed_runs("anchored")
    _, _, _, want_log = runs["eager"]
    every = rows()["anchored"][1]["anchor_every"]
    for call in ("first", "replayed"):
        took = runs[f"{call}_took"]
        refreshes = {f: t[2] for f, t in enumerate(took, start=1) if f % every == 0}
        drifting = [f for f in refreshes if f in want_log["anchor"]]
        assert drifting and all(not refreshes[f] for f in drifting), refreshes
        assert any(refreshes.values()) or len(refreshes) == len(drifting)
        assert _same(runs[call][0], runs["eager"][0])


@pytest.mark.parametrize("name", ["knn", "knn_anchor"])
def test_the_relocalization_takes_the_grid_deltas_as_an_input(name):
    """The relocalization's conditional composes its hypotheses from the
    grid's deltas ``(K, 4, 4)`` given as a tensor input, one of the frame
    graph's static inputs (a copy from the host may not be captured): made
    once by the pipeline, outside the capture, and equal to
    ``perturbation_grid``'s deltas, so the grid around the gate's pose is
    ``perturbation_grid``'s bit for bit. The body runs at each warm-up and
    capture whatever its predicate holds (as the card captures it), and in
    an emulated replay where its predicate reads true."""
    runs = armed_runs(name)
    grid = runs["relocalize_grid"]
    K = len(grid["yaw_deg"]) * len(grid["translations"])
    static = runs["static_in"]["armed"]
    tracked = len(runs["eager"][3]["health"])
    graphs = len(runs["conditionals"])
    for call in ("first", "replayed"):
        seen = runs[f"{call}_grid"]
        # the first call warms up and captures each graph, then replays
        relocalized = len(runs["eager"][3]["relocalize"])
        assert len(seen) == (2 * graphs if call == "first" else 0) + relocalized
        for poses, deltas in seen:
            assert isinstance(deltas, torch.Tensor) and deltas.shape == (K, 4, 4)
            assert any(deltas is t for t in static)
            eye = torch.eye(4, dtype=deltas.dtype)[None]
            assert torch.equal(T.perturbation_grid(eye, **grid)[0], deltas)
            assert torch.equal(_compose_grid(poses[:, 0], deltas),
                               T.perturbation_grid(poses[:, 0], **grid))


def eager_reads(log: dict, anchored: bool) -> dict:
    """The host reads of each tracked frame when the branches are decided
    on the host (eagerly and under grad): the gate's flags once, and the
    drift gate's once more after a relocalization with the anchor."""
    L = len(log["health"]) + 1
    return {f: 1 + (anchored and f in log["relocalize"]) for f in range(1, L)}


@pytest.mark.parametrize("name", ["knn", "projective", "knn_anchor", "anchored"])
def test_one_read_back_a_frame_where_no_branch_runs(name):
    """Eagerly each tracked frame reads its gate's flags back once, and a
    frame where the relocalization ran with the anchor armed reads the
    anchor's gate once more. Captured without grad, the branches are
    decided on the device and a run reads once, after its last frame: the
    predicates of every frame together."""
    runs = armed_runs(name)
    _, _, _, log = runs["eager"]
    L = len(log["health"]) + 1
    want = eager_reads(log, "anchor_every" in rows()[name][1])
    branch_free = [f for f in range(1, L) if f not in log["relocalize"] + log["anchor"]]
    assert branch_free and all(want[f] == 1 for f in branch_free)
    assert runs["eager"][2] == want
    for call in ("first", "replayed"):
        assert runs[call][2] == {L: 1}, call


@pytest.mark.parametrize("name", ["knn", "anchored"])
def test_an_input_passed_through_comes_back_to_its_own_graph(name):
    """The frame graph returns the anchor as it came on a frame that does
    not refresh it, and the motion without the constant-velocity model:
    the next frame gives them back to the graph of the same key, a static
    input given back to its own graph, which ``graphs._write`` leaves
    alone rather than copying it onto itself. The map and the pose come
    back through the graph's outputs."""
    same = armed_runs(name)["self_writes"]
    if name == "anchored":  # constant velocity: the anchor's points, normals, counts
        assert same > 0 and same % 3 == 0
    else:  # the motion, each replayed frame after the first
        assert same == len(armed_runs(name)["eager"][3]["health"]) - 1


def test_the_health_log_outlives_the_branch_graphs(monkeypatch):
    """The anchored clip over two capacity segments, captured (the second
    call replays every frame) against ``use_jit=False``: each segment has
    its frame graphs, the second's captured later in the pool the first's
    scratch in, and the first segment's replays poison them. The health
    readings the log keeps (copied from each replay's outputs), and the
    poses and map, are eager's bits."""
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
    assert segment["anchor"], segment  # the anchor re-solves in the second segment too
    assert len({key[3] for key in jit.frame_graphs._entries if key[0] == "armed"}) == 2


@pytest.mark.parametrize("armed", [
    dict(relocalize_below=0.2),
    dict(relocalize_below=0.2, anchor_every=3),
], ids=["relocalize", "relocalize_anchor"])
def test_armed_clean_clip_captured_is_the_unarmed_captured_run(monkeypatch, armed):
    """On a clean clip nothing trips: the captured armed run (second call,
    every frame replayed) gives the captured unarmed run's bits, reads back
    once, after the last frame, and runs no branch."""
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
    assert reads == {8: 1}


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
    the same branch frames in every step. The projective tracker armed on
    the kidnap (cut after the kidnapped frame) relocalizes on frame 8; the
    anchored clip re-solves against its anchor on most frames, with
    refreshes. Three iterations a solve and four a recovery solve: the
    bits, not the recovery, are under test.

    The branches are decided on the device, as ``jax.grad`` through
    ``lax.cond``: each tracked frame is one ``FrameGraphs.grad`` call of
    the key ``'armed'`` (no branch body of its own), and a step reads
    twice, after the forward's last frame and after the backward's.
    Without remat the first step grows the branches' stores (the
    relocalization ran on a replayed frame), so its forward runs twice and
    reads once more; the second step grows nothing."""
    arrays, kw, want, ran = eager_grad_steps(name)
    counted = Counted(monkeypatch)
    emulate(monkeypatch)
    names = spy_on_frame_graphs(monkeypatch)
    jit = T.PointFusion(remat=remat, **kw)
    counted.slam = jit
    got = []
    for i, (s, r) in enumerate(zip(GRAD_SCALES, ran)):
        names.clear()
        counted.reads.clear()
        regrows = jit.frame_graphs.regrows
        got.append(_grad_step(jit, arrays, s))
        assert jit.last_call_captured and _branches(jit) == r
        tracked = len(jit.recovery_log["health"])
        regrew = jit.frame_graphs.regrows - regrows
        assert regrew == (not remat and i == 0)
        assert dict(names) == {("grad", "armed"): (1 + regrew) * tracked}
        assert counted.reads == {tracked + 1: 2 + regrew}
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
    r"""The emulated captured armed run of the 1-NN row (every frame
    replayed as one graph whose branches are decided on the device, as
    JAX decides its ``lax.cond``\ s), and of the 1-NN row with the anchor
    armed too, against the JAX package's jitted armed ``forward`` on the
    same clip: poses within
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
    # the branch frames came from the predicates the graph decided, read once
    assert runs["keys"] == ["armed"] and runs["replayed"][2] == {R.L: 1}
    took = runs["replayed_took"]
    assert [f + 1 for f, t in enumerate(took) if t[0]] == jax_frames
    if "anchor_every" in kw:
        assert [f + 1 for f, t in enumerate(took) if t[1]] == log["anchor"]


def test_when_runs_only_inside_a_warm_up_or_capture():
    """``graphs.when`` is a conditional of a captured body: an eager caller
    branches on the host, so a call outside ``FrameGraphs``' warm-up or
    capture raises and leaves its outputs as they were."""
    outs = [torch.zeros(2)]
    with pytest.raises(RuntimeError, match="branches on the host"):
        graphs_module.when(torch.tensor(True), lambda: [torch.ones(2)], (), outs)
    assert torch.equal(outs[0], torch.zeros(2))
