"""Armed recovery under autograd decided on the device, tested on the CPU
with the capture emulated (``tests/port/_graph_emulation.py``).

With ``use_jit`` an armed tracked frame under grad is one
``FrameGraphs.grad`` call of the key ``'armed'``, and the recovery branches
and their VJPs are conditional nodes on the same predicates
(``graphs.when`` under autograd), as ``jax.grad`` of a ``lax.cond`` is a
``lax.cond`` over the branches' VJPs. With ``remat`` the forward replays
the no-grad frame graph and the backward a graph of the recompute and its
VJP; without it (``test_torch_graphs_armed_grad_nomat.py``) the forward
keeps each branch's residuals only where it ran. Held here:

- A differentiable conditional on a toy body, its predicate true and false,
  through warm-ups, captures and replays: the gradients of the eager
  ``torch.where`` form; with NaN residuals in a branch whose predicate is
  false (square roots of negatives), the gradients the host's decision
  gives, finite, where the ``torch.where`` form's are NaN. A recompute whose
  predicates differ from the forward's raises at the backward's read; a
  conditional under autograd without remat is captured too.
- Which path an armed ``forward`` takes is a pure function of (captured,
  grad, remat) (``icpslam.armed_on_device``): on the device when captured.
- On the 60x80 kidnap cut after frame 8 (1-NN tracker) and the short
  anchored clip (the anchor re-solve on frames 4-6, refreshes): one
  ``'armed'`` grad call a tracked frame and two reads a step; the
  pipeline's recompute told to decide otherwise raises.
- The captured armed gradients against ``jax.grad`` of the JAX package's
  jitted armed ``forward`` (remat on) on those clips, computed on the CPU
  by ``tests/port/make_armed_grad_golden.py`` into the committed golden
  ``tests/port/data/armed_grad_jax_cpu.npz`` (its two compiles take about
  a minute and a half; the golden's inputs are checked against this
  file's): the same relocalization and anchor re-solve frames, poses
  within 1e-4, and the gradients to the depth and the intrinsics within
  1e-3 of max |g_jax| (PERF.md §2's tracked bar). At the same depths the
  depth gradient misses that bar, by 4.7e-2 (kidnap) and 6.7e-2 (anchored)
  of max |g_jax|, at 27 and 77 pixels (of 43,200 and 33,600): near ties
  whose side float32 rounding decides. JAX's own gradient jumps by as much
  there when the depths are scaled by 1 + 1e-6 (kidnap) or 1 + 1e-7
  (anchored), and the port's is then within 1e-4 of it. So at a pixel
  where JAX's own gradient moves by more than the bar under a relative
  depth change of at most 1e-6 (up to eight float32 ulps), the port's is
  held to JAX's at one of those depths; at every other pixel to JAX's at
  the same depths.
"""

import hashlib
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import gradslam_torch as T  # noqa: E402
from gradslam_torch.slam import icpslam as icpslam_module  # noqa: E402
from gradslam_torch.utils import graphs as graphs_module  # noqa: E402
from gradslam_torch.utils.graphs import FrameGraphs  # noqa: E402

from . import test_torch_graphs_armed as A  # noqa: E402
from . import test_torch_recovery as R  # noqa: E402
from ._graph_emulation import emulate  # noqa: E402


from ._threads import one_thread  # noqa: E402,F401


# ---------------------------------------------------------------------- #
# The differentiable conditional on a toy body
# ---------------------------------------------------------------------- #
def toy_branch(x, w):
    return [torch.sqrt(x) * w + torch.cumsum(x, -1)]


def toy_body(x, w, gate, decide):
    """A conditional whose pass-through and branch both carry gradients; every
    input is used outside the branch too, as an armed frame's are."""
    y = decide(gate[0] > 0, toy_branch, (x, w), [x * 2.0])[0]
    return (y ** 2).sum(-1) + (x * w).sum(-1)


def on_host(pred, body, args, outs):
    return list(body(*args)) if bool(pred) else outs


def by_where(pred, body, args, outs):
    """The eager ``torch.where`` form: the branch runs whatever ``pred``, its
    inputs through one view each as an eager body's (``icpslam.
    _through_views``), so that its uses' gradients sum there first."""
    new = body(*icpslam_module._through_views(args))
    return [torch.where(pred, n, out) for n, out in zip(new, outs)]


def toy_step(run, on, x0, w0):
    x, w = x0.clone().requires_grad_(), w0.clone().requires_grad_()
    out = run(x, w, torch.tensor([on]))
    out.sum().backward()
    return out.detach(), x.grad, w.grad


def captured_toy(graphs, read=lambda flags: flags.tolist()):
    def run(x, w, gate):
        out = graphs.grad("toy", lambda *a: toy_body(*a, graphs_module.when), (x, w, gate),
                          remat=True, read=read)
        graphs.settle()  # the forward's predicates, as ICPSLAM.forward reads them
        return out
    return run


def toy_inputs(poisoned=False):
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.rand(2, 16).astype(np.float32) + 0.1)
    w = torch.from_numpy(rng.randn(2, 16).astype(np.float32))
    return (-x if poisoned else x), w


@pytest.mark.parametrize("on", [1.0, 0.0], ids=["true", "false"])
def test_differentiable_when_gives_the_torch_where_gradients(monkeypatch, on):
    """Three gradient steps through one ``FrameGraphs.grad`` key with remat
    (the warm-up, the frame graph's capture with the backward's, replays):
    the outputs and both inputs' gradients equal the ``torch.where`` form's,
    whose branch runs whatever the predicate (on finite residuals the two
    agree); each step's backward reads its predicates once."""
    emulate(monkeypatch)
    reads = []
    graphs = FrameGraphs()
    run = captured_toy(graphs, lambda flags: reads.append(1) or flags.tolist())
    x0, w0 = toy_inputs()
    want = toy_step(lambda x, w, g: toy_body(x, w, g, by_where), on, x0, w0)
    for _ in range(3):
        reads.clear()
        got = toy_step(run, on, x0, w0)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert reads == [1]
    assert graphs.counts() == {"frame": 1, "forward": 0, "backward": 1}


def test_a_false_branch_leaves_its_nan_residuals_out(monkeypatch):
    """The branch's input negative where its predicate is false: its square
    roots, the residuals its VJP would read, are NaN. The ``torch.where``
    form's gradient is NaN (0 times NaN); the conditional's, in the
    warm-up, the step that captures and a replay, is the host's decision's
    bit for bit and finite: the warm-up runs the VJP and selects its result
    away, the captured backward's conditional does not run."""
    emulate(monkeypatch)
    x0, w0 = toy_inputs(poisoned=True)
    where = toy_step(lambda x, w, g: toy_body(x, w, g, by_where), 0.0, x0, w0)
    assert not bool(torch.isfinite(where[1]).all())
    want = toy_step(lambda x, w, g: toy_body(x, w, g, on_host), 0.0, x0, w0)
    run = captured_toy(FrameGraphs())
    for _ in range(3):
        got = toy_step(run, 0.0, x0, w0)
        assert all(bool(torch.isfinite(t).all()) for t in got)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_a_recompute_that_decides_otherwise_raises(monkeypatch):
    """The backward's predicates are read after its last frame and held to
    the forward's: a gate changed between the forward and the backward (its
    bytes rewritten unseen by autograd, so the recompute reads it) makes the
    backward raise."""
    emulate(monkeypatch)
    run = captured_toy(FrameGraphs())
    x0, w0 = toy_inputs()
    for _ in range(2):
        toy_step(run, 1.0, x0, w0)
    x, w = x0.clone().requires_grad_(), w0.clone().requires_grad_()
    gate = torch.tensor([1.0])
    out = run(x, w, gate)
    gate.data.fill_(0.0)
    with pytest.raises(RuntimeError, match="decided its conditionals"):
        out.sum().backward()


def test_a_conditional_under_grad_needs_remat(monkeypatch):
    """Without remat too ``FrameGraphs.grad`` captures a body with a
    conditional (the warm-up, then the forward graph with the body's
    store): the call's result and gradients are the ``torch.where``
    form's, and the forward graph holds the conditional's predicate beside
    its store (``test_torch_graphs_armed_grad_nomat.py`` holds the rest)."""
    emulate(monkeypatch)
    x0, w0 = toy_inputs()
    graphs = FrameGraphs()

    def run(x, w, gate):
        out = graphs.grad("toy", lambda *a: toy_body(*a, graphs_module.when), (x, w, gate),
                          remat=False)
        graphs.settle()
        return out

    want = toy_step(lambda x, w, g: toy_body(x, w, g, by_where), 1.0, x0, w0)
    for step in range(2):
        got = toy_step(run, 1.0, x0, w0)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        if step == 0:  # the warm-up ran the body: its store grows, the key's graphs go
            assert graphs.regrows == 1 and not graphs._kept
    (entry,) = graphs._kept.values()  # captured again, with a slot for the body
    assert graphs.counts()["forward"] == 1 and len(entry.forward.preds) == 1
    assert len(entry.stores) == 1 and entry.stores[0].capacity == 1


@pytest.mark.parametrize("captured", [False, True], ids=["eager", "captured"])
@pytest.mark.parametrize("grad", [False, True], ids=["no_grad", "grad"])
@pytest.mark.parametrize("remat", [False, True], ids=["remat_off", "remat_on"])
def test_where_an_armed_forward_decides_is_a_pure_choice(captured, grad, remat):
    """On the device when captured, without grad or under it, with remat or
    without; on the host eagerly."""
    want = captured
    assert icpslam_module.armed_on_device(captured, grad, remat) is want


# ---------------------------------------------------------------------- #
# The pipeline, and the JAX package
# ---------------------------------------------------------------------- #
CUT = dict(numiters=3, relocalize_numiters=4)  # as eager_grad_steps: the bits, not the recovery
# the depths scaled by 1 + s for JAX's reference: the same depths, and one
# to eight float32 ulps away either way
SCALES = (0.0, 1e-7, -1e-7, 2e-7, -2e-7, 1e-6, -1e-6)
BAR = 1e-3  # PERF.md §2's tracked bar: max |Δg| ≤ 1e-3 · max |g_jax|
# the JAX package's CPU run of each row (tests/port/make_armed_grad_golden.py)
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      "armed_grad_jax_cpu.npz")


def grad_row(name: str) -> tuple:
    """``(arrays, options)``: the 1-NN kidnap cut after frame 8 (with the
    anchor armed too for ``'knn_anchor'``), or the anchored clip, each
    solve cut as ``eager_grad_steps``'."""
    if name == "anchored":
        arrays, kw = A.rows()["anchored"]
        return arrays, dict(kw, **CUT)
    arrays, jump = A._kidnap_grad_arrays()
    kw = dict(A.KIDNAP, map_capacity=9 * R.H * R.W, **R.rows(jump)["knn"], **CUT)
    return arrays, dict(kw, anchor_every=3) if name == "knn_anchor" else kw


def map_loss_step(slam, arrays):
    """One step of ``sum(points^2)`` of the map to the depths and the
    intrinsics: ``(poses, g_depth, g_K)``."""
    rgb, depth, K, P = (torch.from_numpy(np.asarray(a, np.float32)) for a in arrays)
    d, k = depth.clone().requires_grad_(), K.clone().requires_grad_()
    pc, poses = slam(T.RGBDImages(rgb, d, k, P))
    (pc.points ** 2).sum().backward()
    return poses.detach(), d.grad, k.grad


_CAPTURED = {}


def captured_steps(name: str, remat: bool = True) -> dict:
    """Two emulated captured gradient steps of the row (the second replays
    every frame): each step's results, the bodies it ran through
    ``FrameGraphs`` by ``(method, name)``, its host reads by frame, its
    branch frames, and the stores' regrowths (``regrows``), bytes
    (``store_b``) and bytes the bodies that ran pushed (``pushed_b``).
    Made once a row and mode."""
    if (name, remat) not in _CAPTURED:
        arrays, kw = grad_row(name)
        steps = []
        with pytest.MonkeyPatch.context() as mp:
            counted = A.Counted(mp)
            emulate(mp)
            names = A.spy_on_frame_graphs(mp)
            jit = T.PointFusion(remat=remat, **kw)
            counted.slam = jit
            graphs = jit.frame_graphs
            for _ in range(2):
                names.clear()
                counted.reads.clear()
                regrows = graphs.regrows
                out = map_loss_step(jit, arrays)
                steps.append(dict(out=out, names=dict(names), reads=dict(counted.reads),
                                  branches=A._branches(jit), captured=jit.last_call_captured,
                                  tracked=len(jit.recovery_log["health"]),
                                  regrows=graphs.regrows - regrows, store_b=graphs.store_bytes(),
                                  pushed_b=graphs.pushed_bytes))
        _CAPTURED[name, remat] = steps
    return _CAPTURED[name, remat]


ROWS = ["knn", "anchored"]


@pytest.mark.parametrize("name", ROWS)
def test_one_armed_grad_call_a_frame_and_two_reads_a_step(name):
    """Each tracked frame of each step is one ``FrameGraphs.grad`` call of
    the key ``'armed'`` (no gate, branch or fuse body of its own), and a
    step reads back twice, both after the last frame: the forward's
    predicates and the backward's."""
    for step in captured_steps(name):
        assert step["captured"]
        assert step["names"] == {("grad", "armed"): step["tracked"]}
        assert step["reads"] == {step["tracked"] + 1: 2}


def test_the_pipelines_recompute_told_to_decide_otherwise_raises(monkeypatch):
    """The kidnap row's captured first step with the relocalization
    threshold raised between the forward and the backward (the emulated
    recompute runs the body's Python again and reads it): the recompute
    relocalizes on frames the forward did not, and the backward's read
    raises rather than give the gradient of another forward."""
    arrays, kw = grad_row("knn")
    emulate(monkeypatch)
    jit = T.PointFusion(remat=True, **kw)
    rgb, depth, K, P = (torch.from_numpy(np.asarray(a, np.float32)) for a in arrays)
    d = depth.clone().requires_grad_()
    pc, _ = jit(T.RGBDImages(rgb, d, K, P))
    assert jit.last_call_captured and jit.recovery_log["relocalize"] == [8]
    jit.relocalize_below = 1.5  # above any inlier fraction: every frame unhealthy
    with pytest.raises(RuntimeError, match="decided its conditionals"):
        (pc.points ** 2).sum().backward()


def inputs_digest(arrays, kw) -> str:
    """SHA-256 of a row's float32 input arrays and its options."""
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a, dtype=np.float32).tobytes())
    h.update(json.dumps(kw, sort_keys=True).encode())
    return h.hexdigest()


def golden(name: str) -> dict:
    """The JAX package's row from ``GOLDEN`` (``make_armed_grad_golden.py``)."""
    data = np.load(GOLDEN)
    return {k[len(name) + 1:]: data[k] for k in data.files if k.startswith(name + "_")}


@pytest.mark.parametrize("name", ROWS)
def test_the_golden_holds_the_rows_inputs(name):
    """The committed JAX golden was made from this file's inputs and
    options, and holds every key the comparison reads."""
    arrays, kw = grad_row(name)
    ref = golden(name)
    assert str(ref["inputs"]) == inputs_digest(arrays, kw)
    L = np.asarray(arrays[1]).shape[1]
    assert ref["poses"].shape == (1, L, 4, 4) and ref["readings"].shape == (L - 1, 1)
    assert ref["drift"].shape == ((L - 1,) if "anchor_every" in kw else (0,))
    assert ref["grad_depth"].shape == np.asarray(arrays[1]).shape
    assert ref["tie_grads"].shape == (len(ref["tie"]), len(SCALES))


@pytest.mark.parametrize("name", ROWS)
def test_armed_gradients_against_the_jax_packages_grad(name):
    """The replayed captured step against ``jax.grad`` through the JAX
    package's jitted armed forward (the module docstring; its CPU run is
    the committed golden): the same relocalization and anchor re-solve
    frames, poses within 1e-4, the intrinsics gradient within 1e-3 of max
    |g_jax|, and at every pixel the depth gradient within 1e-3 of max
    |g_jax| of JAX's at the same depths, or, at a pixel where JAX's own
    gradient moves by more than that under a relative change of the depths
    of at most 1e-6 (a near tie that float32 rounding decides), of JAX's
    at one of those depths. The gap at the same depths and the near-tie
    pixels are reported (PERF.md §6)."""
    hold_to_the_golden(name, captured_steps(name)[1])


def hold_to_the_golden(name: str, step: dict) -> None:
    """A captured step of row ``name`` against the JAX golden at the bars of
    :func:`test_armed_gradients_against_the_jax_packages_grad`."""
    arrays, kw = grad_row(name)
    ref = golden(name)
    poses, gd, gk = step["out"]
    np.testing.assert_allclose(poses.numpy(), ref["poses"], atol=1e-4, rtol=0)
    jax_frames = [f + 1 for f, r in enumerate(ref["readings"])
                  if (r < kw["relocalize_below"]).any()]
    assert step["branches"]["relocalize"] == jax_frames
    assert step["branches"]["anchor"] == [f + 1 for f, d in enumerate(ref["drift"]) if d]
    assert step["branches"] == {"knn": {"relocalize": [8], "anchor": []},
                                "anchored": {"relocalize": [], "anchor": [4, 5, 6]}}[name]
    jd, jk = ref["grad_depth"].astype(np.float64), ref["grad_K"].astype(np.float64)
    md = np.abs(jd).max()
    k_gap = float(np.abs(gk.numpy() - jk).max() / np.abs(jk).max())
    gap = (np.abs(gd.numpy() - jd) / md).reshape(-1)
    tie = np.zeros(gap.shape, bool)
    tie[ref["tie"]] = True
    at_tie = np.abs(gd.numpy().reshape(-1)[ref["tie"], None] - ref["tie_grads"]) / md
    nearest = at_tie.min(axis=1).max() if tie.any() else 0.0
    reading = (f"{name}: depth gap {gap.max():.4e} of max |g_jax| at the same depths, "
               f"{gap[~tie].max():.4e} off the {int(tie.sum())} near-tie pixels of "
               f"{tie.size}, {nearest:.4e} there against the nearest of JAX's; intrinsics "
               f"{k_gap:.4e}")
    print(reading)
    assert k_gap <= BAR, reading
    assert gap[~tie].max() <= BAR and nearest <= BAR, reading
