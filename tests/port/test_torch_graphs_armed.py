"""Armed recovery (``relocalize_below > 0``, with and without
``anchor_every``) replayed as CUDA graphs, tested on the CPU with the
capture emulated as in ``test_torch_graphs.py`` (a stand-in graph whose
replay runs the body again into the same static outputs).

Each tracked frame is a gate graph, one read back of its flags, the
recovery branches eagerly where they are needed, and a fuse graph
(``ICPSLAM._track``). Held here:

- The emulated armed ``forward`` gives the ``use_jit=False`` bits (poses
  and map), the same ``recovery_log`` (every gate reading, the branch
  frames) and the same launch counters (counted at the kernels'
  dispatchers), on the kidnapped clip of ``test_torch_recovery.py``
  (60x80x11, the 1-NN and the projective tracker: the relocalization runs
  on frame 8) and on its short anchored clip with ``anchor_below=1.0``
  (the anchor re-solve runs on most frames).
- One host read (``icpslam._read_back``) on each tracked frame where no
  branch runs; after a relocalization an anchored frame reads once more.
- The anchor, which the gate passes through, comes back to the gate's own
  static inputs on a frame that does not refresh it (and is not copied
  onto itself there).
- Armed on a clean clip, the captured run is the unarmed captured run.
- Under grad, with ``remat`` on and off, the captured armed gradients to
  the depth and the intrinsics are eager's bits over two steps, on the
  kidnap (projective tracker) and on the anchored clip.
- The emulated armed run against the JAX package's jitted armed
  ``forward``: poses within 1e-4, each gate reading within 1/N, the same
  relocalization frames.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import gradslam_torch as T  # noqa: E402
from gradslam_torch.ops import knn_cuda, scatter_cuda  # noqa: E402
from gradslam_torch.slam import icpslam as icpslam_module  # noqa: E402
from gradslam_torch.utils import graphs as graphs_module  # noqa: E402
from gradslam_torch.utils.graphs import clone_tree  # noqa: E402

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
    """Each armed row: ``(arrays, options)``."""
    arrays, jump = kidnap_arrays()
    out = {name: (arrays, dict(KIDNAP, **row)) for name, row in R.rows(jump).items()}
    out["anchored"] = (T.hard_sequence(1, 7, R.H, R.W, outlier_frac=0.0), ANCHORED)
    return out


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
    calls were captured, and the static inputs that the replayed call gave
    back to their own graph (``self_writes``). Made once a row."""
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
        jit = T.PointFusion(**kw)
        for call in ("first", "replayed"):
            self_writes.clear()
            out = counted.run(jit, frames)
            got[call] = (clone_tree(out[0]), *out[1:], jit.recovery_log)
            got[f"{call}_captured"] = jit.last_call_captured
        got["self_writes"] = sum(self_writes)
        got["graphs"] = jit.frame_graphs.counts()
        got["keys"] = sorted({key[0] for key in jit.frame_graphs._entries})
    _RUNS[name] = got
    return got


def _same_log(a, b) -> bool:
    return (a["relocalize"] == b["relocalize"] and a["anchor"] == b["anchor"]
            and len(a["health"]) == len(b["health"])
            and all(torch.equal(x, y) for x, y in zip(a["health"], b["health"])))


@pytest.mark.parametrize("name", ["knn", "projective", "anchored"])
def test_armed_forward_captured_gives_the_eager_bits(name):
    """The emulated captured run, first and replayed call, against
    ``use_jit=False``: the same poses and map bits, gate readings and
    branch frames, and the same launch counters; each call captured, with
    a gate and a fuse graph."""
    runs = armed_runs(name)
    want, want_launches, _, want_log = runs["eager"]
    assert want_log["relocalize"] == ([8] if name != "anchored" else want_log["relocalize"])
    if name == "anchored":
        assert len(want_log["anchor"]) >= 3
    for call in ("first", "replayed"):
        out, launches, _, log = runs[call]
        assert runs[f"{call}_captured"]
        assert _same(out, want), call
        assert _same_log(log, want_log), call
        assert launches == want_launches, call
    assert runs["keys"] == ["fuse", "gate"]
    assert runs["graphs"]["frame"] >= 2


@pytest.mark.parametrize("name", ["knn", "projective", "anchored"])
def test_one_read_back_a_frame_where_no_branch_runs(name):
    """Each tracked frame reads its gate's flags back once; a frame where
    the relocalization ran with the anchor armed reads the anchor's gate
    once more. Eager and captured read alike."""
    runs = armed_runs(name)
    _, _, _, log = runs["eager"]
    L = len(log["health"]) + 1
    anchored = name == "anchored"
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
    the same branch frames in every step, each branch's gradient through
    the eager code between the graphs. The projective tracker armed on the
    kidnap (cut after the kidnapped frame) relocalizes on frame 8; the
    anchored clip re-solves against its anchor on most frames, with
    refreshes. Three iterations a solve and four a recovery solve: the
    bits, not the recovery, are under test."""
    arrays, kw, want, ran = eager_grad_steps(name)
    emulate(monkeypatch)
    jit = T.PointFusion(remat=remat, **kw)
    got = []
    for s, r in zip(GRAD_SCALES, ran):
        got.append(_grad_step(jit, arrays, s))
        assert jit.last_call_captured and _branches(jit) == r
    assert jit.frame_graphs.counts()["backward"] >= 2 and jit.frame_graphs.replays > 0
    assert all(_same_grads(g, w) for g, w in zip(got, want))
    assert bool(torch.isfinite(got[1][2]).all()) and not torch.equal(got[0][2], got[1][2])


def test_armed_capture_against_the_jax_packages_jit(monkeypatch):
    """The emulated captured armed run of the 1-NN row (every frame
    replayed) against the JAX package's jitted armed ``forward`` on the
    same clip: poses within 1e-4, each gate reading within 1/N (N the rows
    scored, at least 300), the relocalization on the same frames. (The
    projective row is held to ``use_jit=False``'s bits above, and that to
    JAX in ``test_torch_recovery.py``.)"""
    name = "knn"
    arrays, kw = rows()[name]
    _, jposes, readings = R.jax_run(monkeypatch, arrays, kw)
    runs = armed_runs(name)
    (_, poses), _, _, log = runs["replayed"]
    np.testing.assert_allclose(poses.numpy(), jposes, atol=1e-4, rtol=0)
    ours = torch.stack(log["health"]).numpy()
    assert ours.shape == readings.shape == (R.L - 1, R.B)
    np.testing.assert_allclose(ours, readings, atol=1.0 / 300 + 1e-7, rtol=0)
    jax_frames = [f + 1 for f in range(R.L - 1) if (readings[f] < 0.5).any()]
    assert log["relocalize"] == jax_frames == [8]
