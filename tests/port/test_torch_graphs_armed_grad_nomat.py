"""Armed recovery under autograd without remat, decided on the device: the
JAX package's default (``use_jit=True, remat=False``), tested on the CPU
with the capture emulated (``tests/port/_graph_emulation.py``).

Without remat an armed tracked frame under grad is one
``FrameGraphs.grad`` call of the key ``'armed'``: its forward graph holds
the recovery branches as conditional nodes and is captured under the
saved-tensor hooks; the tensors a branch's body saves go, in a second
node on "the predicate and a free slot", to that body's store, so a frame
keeps a branch's residuals only where the branch ran, as eagerly; the
backward graph's node for the branch's VJP copies its frame's slot back
before it runs. A store is sized by the forwards before it; the first
forward that outgrows it is read, grown and run again (``regrows``).
Held here:

- A toy conditional through one key, over forwards of several calls whose
  predicates change: the results and gradients the ``torch.where`` form
  gives, bit for bit; a forward whose predicates are all false pushes
  nothing and keeps no more than the frame's own arena; the store holds
  exactly one slot of the body's saved bytes for each call where the
  predicate held; a forward that outgrows the store regrows once, its
  backward raises, and its run again gives the same bits; two forwards
  before one backward give the bits of the same two eager forwards, the
  second taking the slots after the first's (one regrowth to hold both),
  and the counter starts again once their backward has run.
- The 60x80 kidnap cut after frame 8 (1-NN tracker; and with the anchor
  armed too, whose re-solve never runs) and the short anchored clip
  (``test_torch_graphs_armed_grad.grad_row``): the captured steps
  SHA-256-equal to ``use_jit=False`` without remat; after the first step,
  which grows the stores once (and so runs its forward twice, reading once
  more), one ``'armed'`` call a tracked frame, two reads a step, no
  regrowth, and the stores holding what the branches that ran saved; and
  (the first two) the replayed step against ``jax.grad`` of the JAX
  package's armed forward
  (the committed golden, made with remat: JAX's remat-off gradients on the
  same inputs equal it within 1e-6 of max |g|, CHANGES.md) at the bars the
  remat rows are held to.
"""

import hashlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import gradslam_torch as T  # noqa: E402
from gradslam_torch.slam import icpslam as icpslam_module  # noqa: E402
from gradslam_torch.utils import graphs as graphs_module  # noqa: E402
from gradslam_torch.utils.graphs import FrameGraphs  # noqa: E402

from . import test_torch_graphs_armed_grad as G  # noqa: E402
from ._graph_emulation import emulate  # noqa: E402


from ._threads import one_thread  # noqa: E402,F401


# ---------------------------------------------------------------------- #
# A toy conditional over forwards of several calls
# ---------------------------------------------------------------------- #
B, N = 2, 16
SLOT = B * N * 4  # bytes: the branch saves one (B, N) float32 tensor (tanh's output)


def toy_branch(x, w):
    return [torch.tanh(x) * w + 0.1 * torch.cumsum(x, -1)]


def toy_frame(x, w, gate, decide):
    """One call: a conditional whose pass-through and branch both carry
    gradients, every input used outside the branch too."""
    y = decide(gate[0] > 0, toy_branch, (x, w), [x * 0.5])[0]
    return y * y + x * w


def toy_forward(run, gates, x0, w0):
    """One gradient step over the calls ``gates`` (each call's output the
    next one's input): the output and both inputs' gradients."""
    x, w = x0.clone().requires_grad_(), w0.clone().requires_grad_()
    out = run(x, w, gates)
    out.sum().backward()
    return out.detach(), x.grad, w.grad


def eager(x, w, gates):
    """The toy forward eagerly, each call's inputs through one view first
    (as an eager armed frame's, ``icpslam._through_views``: their uses'
    gradients sum there, as in a call's backward graph)."""
    for g in gates:
        x = toy_frame(*icpslam_module._through_views((x, w)), torch.tensor([g]), G.by_where)
    return x


class Captured:
    """The toy forward through one ``FrameGraphs.grad`` key without remat,
    read once after its last call, and run again where that read grew a
    store (as ``ICPSLAM.forward``). ``attempts`` keeps each run's output
    before the read."""

    def __init__(self):
        self.graphs = FrameGraphs()
        self.reads = 0
        self.attempts = []

    def read(self, flags):
        self.reads += 1
        return flags.tolist()

    def once(self, x, w, gates):
        y = x
        for g in gates:
            y = self.graphs.grad("toy", lambda *a: toy_frame(*a, graphs_module.when),
                                 (y, w, torch.tensor([g])), remat=False, read=self.read)
        self.graphs.settle(self.read)
        self.attempts.append(y)
        return y

    def __call__(self, x, w, gates):
        y = self.once(x, w, gates)
        return self.once(x, w, gates) if self.graphs.regrew else y

    def store(self):
        (entry,) = self.graphs._kept.values()
        (store,) = entry.stores
        return store


def toy_inputs():
    rng = np.random.RandomState(1)
    return (torch.from_numpy(rng.rand(B, N).astype(np.float32)),
            torch.from_numpy(rng.randn(B, N).astype(np.float32) * 0.5))


@pytest.fixture()
def toy(monkeypatch):
    emulate(monkeypatch)
    return Captured()


def test_forwards_with_changing_predicates_give_the_eager_bits(toy):
    """Forwards of five calls through one key: the first warms up, captures
    and grows the store for its two branch calls (its forward runs twice);
    then the branch on other calls (the warm-up's among them) and on none:
    each step's
    output and gradients are the ``torch.where`` form's bits, read twice a
    step after the first (the forward's predicates and counters, the
    backward's predicates)."""
    x0, w0 = toy_inputs()
    for gates in ((0.0, 1.0, 0.0, 1.0, 0.0), (1.0, 0.0, 0.0, 1.0, 0.0),
                  (0.0,) * 5, (0.0, 1.0, 1.0, 0.0, 0.0)):
        toy.reads, regrows = 0, toy.graphs.regrows
        want = toy_forward(eager, gates, x0, w0)
        got = toy_forward(toy, gates, x0, w0)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), gates
        assert toy.reads == 2 + (toy.graphs.regrows - regrows), gates
    assert toy.graphs.regrows == 1
    assert toy.graphs.counts() == {"frame": 0, "forward": 1, "backward": 1}


def test_a_false_branch_keeps_nothing(toy):
    """The store holds one slot of the body's saved bytes (tanh's output,
    ``SLOT``; its input ``w`` is the call's, kept as such) for each call
    of the sizing forward where the predicate held; a forward pushes one
    slot for each true predicate and none for a false one, and its calls'
    arenas keep the same bytes whatever the predicates."""
    x0, w0 = toy_inputs()
    toy_forward(toy, (0.0, 1.0, 0.0, 1.0, 0.0), x0, w0)  # sized: two slots
    store = toy.store()
    assert (store.capacity, store.layout.total) == (2, SLOT)
    assert toy.graphs.store_bytes() == 2 * SLOT
    arenas = {}
    for gates, pushed in (((0.0,) * 5, 0), ((1.0, 0.0, 0.0, 0.0, 0.0), 1),
                          ((0.0, 1.0, 0.0, 1.0, 0.0), 2)):
        kept = toy.graphs.kept_bytes
        toy_forward(toy, gates, x0, w0)
        arenas[gates] = toy.graphs.kept_bytes - kept
        assert toy.graphs.pushed_bytes == pushed * SLOT, gates
        assert int(store.count) == pushed and toy.store() is store, gates
    assert len(set(arenas.values())) == 1 and toy.graphs.regrows == 1


def test_an_overflow_regrows_once_with_the_same_bits(toy):
    """A forward whose branch runs on more calls than the store holds: the
    pushes past it store nothing, the read grows the store (one more
    regrowth), the backward of that first run raises rather than read
    what was not stored, and the forward run again gives the eager bits;
    the next forward replays without growing."""
    x0, w0 = toy_inputs()
    toy_forward(toy, (0.0, 1.0, 0.0, 0.0, 0.0), x0, w0)  # sized: one slot
    assert (toy.store().capacity, toy.graphs.regrows) == (1, 1)
    gates = (0.0, 1.0, 1.0, 0.0, 1.0)
    want = toy_forward(eager, gates, x0, w0)
    toy.attempts.clear()
    got = toy_forward(toy, gates, x0, w0)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert toy.graphs.regrows == 2 and toy.store().capacity == 3
    first = toy.attempts[0]  # the run whose pushes outgrew the store
    with pytest.raises(RuntimeError, match="residuals are gone"):
        first.sum().backward()
    got = toy_forward(toy, gates, x0, w0)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert toy.graphs.regrows == 2 and toy.graphs.pushed_bytes == 3 * SLOT


class TwoKeys(Captured):
    """The toy forward with its calls through two keys in turn, as an
    anchored pipeline's refresh frames have a key of their own."""

    def once(self, x, w, gates):
        y = x
        for i, g in enumerate(gates):
            y = self.graphs.grad(f"toy{i % 2}", lambda *a: toy_frame(*a, graphs_module.when),
                                 (y, w, torch.tensor([g])), remat=False, read=self.read)
        self.graphs.settle(self.read)
        self.attempts.append(y)
        return y


def test_a_regrowth_gives_back_every_key_s_slots(monkeypatch):
    """Where a forward's read grows one key's store, that forward's calls
    of the other key give their slots back too (the forward runs again,
    its first run held until the second returns): the other key's counter
    starts again, nothing grows twice, and the bits are eager's; the
    first run's backward raises."""
    emulate(monkeypatch)
    toy = TwoKeys()
    x0, w0 = toy_inputs()
    toy_forward(toy, (0.0, 1.0, 0.0, 1.0, 0.0, 1.0), x0, w0)  # sized: toy1 three slots
    assert toy.graphs.regrows == 1
    gates = (0.0, 1.0, 1.0, 1.0, 0.0, 1.0)  # toy0 now needs a slot; toy1 fills its three
    want = toy_forward(eager, gates, x0, w0)
    toy.attempts.clear()
    got = toy_forward(toy, gates, x0, w0)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert toy.graphs.regrows == 2 and toy.graphs.pushed_bytes == 4 * SLOT  # toy0 1, toy1 3
    with pytest.raises(RuntimeError, match="residuals are gone"):
        toy.attempts[0].sum().backward()


def test_two_forwards_before_one_backward_give_the_eager_bits(toy):
    """``loss = f(a) + f(b); loss.backward()`` through one key: the first
    forward's calls hold their slots until the backward, so the second
    takes the slots after theirs; where both need more than the store
    holds, the second forward's read grows it (one regrowth) and runs it
    again, while the first forward's calls keep the store they pushed
    into. The output and gradients are those of the same two eager
    forwards, bit for bit; a second round fits without growing, and once
    the backward has run no call holds a slot: the next forward's counter
    starts again."""
    x0, w0 = toy_inputs()
    toy_forward(toy, (0.0, 1.0, 0.0, 1.0, 0.0), x0, w0)  # sized: two slots
    gates = ((1.0, 0.0, 0.0, 1.0, 0.0), (0.0, 1.0, 1.0, 0.0, 0.0))

    def both(run):
        return lambda x, w, _: sum(run(x, w, g) for g in gates)

    want = toy_forward(both(eager), None, x0, w0)
    for taken in (2, 4):  # the slots taken: the second forward's run again alone, then both
        got = toy_forward(both(toy), None, x0, w0)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert toy.graphs.regrows == 2 and toy.store().capacity == 4
        assert toy.store().base == taken and toy.store().held == 0
    toy_forward(toy, gates[0], x0, w0)
    assert int(toy.store().count) == 2 and toy.graphs.pushed_bytes == 2 * SLOT


# ---------------------------------------------------------------------- #
# The pipeline rows
# ---------------------------------------------------------------------- #
ROWS = G.ROWS
# and the kidnap with the anchor armed: a branch (the anchor re-solve) that
# never runs, refresh frames, and the relocalization on frame 8
BITS_ROWS = [*ROWS, "knn_anchor"]
_EAGER = {}


def eager_step(name: str) -> tuple:
    """One ``use_jit=False`` gradient step of the row without remat."""
    if name not in _EAGER:
        arrays, kw = G.grad_row(name)
        _EAGER[name] = G.map_loss_step(T.PointFusion(use_jit=False, remat=False, **kw), arrays)
    return _EAGER[name]


def sha256(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("name", BITS_ROWS)
def test_remat_off_armed_steps_give_the_eager_bits(name):
    """Both captured steps (the first grows the stores and runs its forward
    again) give the poses and the gradients to the depth and the
    intrinsics of ``use_jit=False`` without remat, SHA-256-equal, with the
    same branch frames."""
    want = sha256(eager_step(name))
    for step in G.captured_steps(name, remat=False):
        assert step["captured"] and sha256(step["out"]) == want


@pytest.mark.parametrize("name", BITS_ROWS)
def test_remat_off_one_armed_call_a_frame_and_two_reads_a_step(name):
    """After the first step, each tracked frame is one ``'armed'`` grad call
    and a step reads twice, after the forward's last frame and after the
    backward's, with no regrowth; the first step grows its stores once, so
    its forward runs twice (two calls a frame) and reads once more. The
    stores hold what the branches that ran in a step saved, and some
    branch ran."""
    first, second = G.captured_steps(name, remat=False)
    for step, regrows in ((first, 1), (second, 0)):
        assert step["regrows"] == regrows
        assert step["names"] == {("grad", "armed"): (1 + regrows) * step["tracked"]}
        assert step["reads"] == {step["tracked"] + 1: 2 + regrows}
    assert second["store_b"] == second["pushed_b"] > 0


@pytest.mark.parametrize("name", ROWS)
def test_remat_off_armed_gradients_against_the_jax_packages_grad(name):
    """The replayed captured step without remat against ``jax.grad`` of the
    JAX package's armed forward (the golden), at the bars and with the
    near-tie rule of ``test_armed_gradients_against_the_jax_packages_grad``."""
    G.hold_to_the_golden(name, G.captured_steps(name, remat=False)[1])
