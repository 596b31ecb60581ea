r"""CUDA graphs of a pipeline's frame body: the port's counterpart of ``jax.jit``.

In the JAX package ``use_jit=True`` (the default) compiles ``forward``,
``step``, ``localize`` and the map-only update into one device program each,
and inside ``forward`` the frame recurrence is a ``lax.scan`` over one
compiled frame body (``gradslam_tpu/slam/icpslam.py:325``, ``:545-560``,
``:1253``, ``:1394``). On the card the counterpart of a compiled scan body is
a CUDA graph of the frame body: captured once for each key and replayed for
every frame that has that key.

:class:`FrameGraphs` is a pipeline's cache of such graphs. A key is the
path's name and options together with the structure of the call's inputs
(dataclass types, ``None`` fields and static fields such as
``normal_pitch``) and each input tensor's shape, dtype and device: so ``B``,
``H``, ``W``, the map's capacity, its feature width, the dtype and the
device. The first call of a key runs the body eagerly (the warm-up, whose
result is the call's result), then captures it on the cache's side stream
into the pool that the cache's graphs share; every later call copies its
inputs into the graph's static inputs, replays, and returns the graph's
static outputs. Those are overwritten by the next replay, so a caller that
keeps a result copies it (:func:`clone_tree`).

Nothing lazy may happen inside a capture: the warm-up builds the kernels and
reads the device limits the 1-NN's split plan needs, and runs under
``torch.cuda.set_sync_debug_mode("error")``, so an operation that would
synchronise with the host (and so break the capture) raises there with its
traceback. A capture that fails raises; nothing carries on eagerly.

Under autograd (a ``forward`` on the card whose inputs need a gradient, as
``jax.grad`` of the jitted forward or a jitted ``value_and_grad`` train step
compiles the backward of the scan) :meth:`FrameGraphs.grad` runs each frame
as one :class:`torch.autograd.Function` whose forward and backward replay
graphs. A replay overwrites its graph's static outputs and every tensor the
captured forward saved for backward, so one graph replayed for every frame
would hand each frame's backward the last frame's activations. The two
forms keep what each frame's backward needs per call:

- ``remat=True``, per-frame checkpointing (``jax.checkpoint`` of the scan
  body): the forward replays the frame body's no-grad graph and the
  ``Function`` saves only the frame's inputs. The backward copies them and
  the output gradients into the static inputs of a second graph, captured
  as "run the body under grad on leaves, then ``torch.autograd.grad``":
  the recompute and the backward's own launches, as eager remat launches.
- ``remat=False``, the residuals kept: the forward is captured under grad
  inside :class:`torch.autograd.graph.saved_tensors_hooks`, which records
  every tensor autograd saves (saved static inputs, static outputs, views
  of them and intermediates); those whose nodes the outputs' backward
  reaches are kept. After each replay the bytes of their storages that
  they read (all but the static inputs') are copied into one new arena
  (:class:`_Arena`) that the call owns; an output that autograd saved is
  a view of it and any other output a copy, so a call keeps what eager
  keeps, in one copy, and autograd sees an in-place edit of such an
  output. The backward, captured once for each set of output gradients as
  ``torch.autograd.grad`` on the captured outputs, replays after one
  frame's arena, saved inputs and output gradients are copied back in.

The first call of a key runs eagerly on the side stream under grad (the
warm-up: its result and its autograd graph are that call's), then the
forward graph is captured; the first backward of each set of output
gradients runs eagerly under ``set_sync_debug_mode("error")`` too (an op
whose gradient synchronises, such as a ``nonzero``, raises there), then is
captured. Gradients to a tensor that every frame shares (the intrinsics)
are each frame's, summed by autograd outside the graphs. An input that the
body returns as it came is returned as that input, uncopied (autograd
makes it a view). Each capture goes through :meth:`FrameGraphs._graph`,
the one place that makes a CUDA graph.

The graphs share one pool, so a graph captured later may keep its static
outputs in memory that an earlier graph uses as scratch: a caller reads a
graph's outputs before it replays another graph (or copies them), and a
body that several graphs run one after another passes what the later ones
read through the first as an input returned as it came: a static input,
which lives outside the pool.

The kernels' launch counters (``ops.knn_cuda.launches``,
``ops.scatter_cuda.launches``) are Python integers that a wrapper raises when
it runs, and the collectives' tallies (``parallel.collectives.BYTES`` and
``CALLS``, ``collections.Counter`` by tag, registered with
:func:`register_tally`) are raised by the helper that issues a collective.
A replay runs no wrapper and no helper, so each graph records what its
capture counted on every counter (and the capture's own increments are
taken back: a capture launches and moves nothing), and every replay adds
it: the counters read the same whether a run was captured or not, forward
and backward.

Collectives are captured like kernels: ``MapShardedPointFusion``'s frame
body issues NCCL all-gathers and all-reduces through
``parallel.collectives`` and is captured whole. Checked on the card by
``tests/port/nccl_capture_probe.py`` (torch 2.11.0+cu128, NCCL 2.28.9, one
rank): a blocking collective (``async_op=False``, as the helpers issue
them) runs on the caller's current stream (the device trace puts NCCL's
work on the stream of the body's kernels, eagerly and in a replay), so in
a capture it is work on the capture stream and joins the graph with no
event between streams; at world size 1 that work is device copies. A
communicator that the first collective makes lazily, inside a warm-up
under the sync debug mode "error", raised nothing; nor did a capture
right after eager collectives, whose work NCCL's watchdog may still be
polling, the replays, or destroying the group. Whether the process group
records its watchdog's or timing events for a captured collective is not
visible in a trace. The caller makes the process group; nothing here
initialises a communicator.

:func:`eager_reason` decides which calls are captured: ``use_jit`` and
inputs on the card, with or without gradients (``forward``, ``step``,
``localize`` and ``map_update`` capture theirs;
``MapShardedPointFusion.forward`` runs under ``no_grad``). It is a pure
function of those facts, so it is tested without a card.

:func:`when` is the counterpart of ``jax.lax.cond`` inside a captured body:
a CUDA graph conditional (IF) node whose predicate the graph computes and
decides on the device, opened by the port's own C entry points
(``ops/csrc/conditional.cu``; the card's torch 2.11 has no
``CUDAGraph.begin_capture_to_if_node``). The node's body is captured on a
stream of its own into a pool of its own (torch's allocator routes that
stream's allocations there while the node is open), and its launches are
counted apart: each replay keeps its predicates on the device, and
:meth:`FrameGraphs.settle` reads them all at once and adds each body's
launches where its predicate was true. A no-grad armed frame is one such
graph (``ICPSLAM._armed``).

Under autograd :func:`when` is differentiable, as ``jax.grad`` of a
``lax.cond`` is a ``lax.cond`` over the branches' VJPs on the same
predicate: one :class:`_When` node whose forward is the IF node (the body
run under grad on detached leaves of its inputs) and whose backward gives
the values that pass through ``torch.where(pred, -0.0, g)`` and the body's
inputs their gradients from a second IF node on the same predicate, which
holds ``torch.autograd.grad`` through the body (on the body's stream,
where its autograd nodes ran: no event joins the streams inside a
capture). Where the predicate is false that node does not run, so nothing
of the body's stale residuals reaches a gradient; its inputs' gradient
buffers, filled with ``-0.0`` outside the node, add nothing to any other
gradient, not even the sign of a zero. An armed frame under grad is one
:meth:`FrameGraphs.grad` call either way. With ``remat`` the forward
replays the no-grad frame graph, the backward a graph of the recompute and
its backward, both with their conditionals decided on the device. The
backward's predicates are read once, after its last frame (a callback
queued on autograd's engine at the first frame's backward); with ``remat``
they must equal the forward's for each frame, or the read raises.

Without ``remat`` the forward is captured under the saved-tensor hooks with
its conditional nodes in it, and a body's residuals are kept only on the
calls where its predicate held, as eagerly (JAX's scan keeps both sides'
on every iteration: a frame of the armed 640x480 row would keep about
330 MB more). The tensors a body saves are recorded apart from the frame's
(:class:`_Kept`); each body has a store (:class:`_Store`: slots of its
saved bytes and a slot counter on the device, made before the capture and
outside the graphs' pool, whose free memory a later graph may use as
scratch, from what the key's warm-up saved), and a second IF node after
the body's, on "predicate and a free slot", gathers them into a stage
(one ``_foreach_copy_``) and copies that into the slot the counter gives
(one ``index_copy_``), and the counter takes a step where the predicate
held. The frame's arena keeps the predicate and the slot; the body's VJP
node in the backward graph copies that slot back through the stage into
the body's own tensors (``index_select``, ``_foreach_copy_``) before its
``autograd.grad`` (a
backward's warm-up, which runs each VJP whatever its predicate, runs a
body's only where the call's forward, read by then, ran it: elsewhere the
body's tensors hold another call's bytes). A
store is sized from the calls of its key in the forwards before (none at
the first capture); :meth:`FrameGraphs.settle` reads the counters with
the predicates, and where a body ran more often than its store holds (a
push past the capacity stores nothing) it grows the store to what the
forward needed, drops the key's graphs (their copies name the store's
memory) and sets ``regrew``: the caller runs that forward again, whose
first call of the key captures the graphs anew (counted in ``regrows``).
A call holds its slots until its backward has run, the call is freed, or
its forward's read grew a store (that forward runs again): a forward that
starts while calls of earlier forwards still hold slots takes the slots
after theirs, so several forwards may run before one backward (their
store grows to hold them all), and the counter starts again at the first
forward when no call holds a slot. A second backward of a call whose
slots were taken again raises.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import time
import weakref
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..ops import knn_cuda, scatter_cuda

__all__ = [
    "FrameGraphs",
    "CapturedCall",
    "flatten",
    "unflatten",
    "clone_tree",
    "eager_reason",
    "eager_reason_for",
    "cache_key",
    "needs_grad",
    "register_tally",
    "when",
]

# the modules whose ``launches`` count their kernel's launches
LAUNCH_COUNTERS = (knn_cuda, scatter_cuda)
# name -> counts by tag that a module registered (:func:`register_tally`)
TALLIES: Dict[str, "collections.Counter[str]"] = {}
# every counter's value: ``(module name, None)`` for a launch counter,
# ``(tally name, tag)`` for a tally
Counts = Dict[Tuple[str, Optional[str]], int]

_TENSOR = "tensor"


def flatten(tree) -> Tuple[List[torch.Tensor], tuple]:
    r"""The tensor leaves of ``tree`` and a hashable spec to rebuild it.

    ``tree`` is a tensor, ``None``, a tuple or list of trees, or a dataclass
    (``Pointclouds``, ``RGBDImages``) whose fields are trees; any other
    value (an int, a bool) is static and kept in the spec."""
    leaves: List[torch.Tensor] = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            leaves.append(x)
            return (_TENSOR,)
        if isinstance(x, (tuple, list)):
            return (type(x), tuple(walk(v) for v in x))
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            return (type(x), tuple((f.name, walk(getattr(x, f.name)))
                                   for f in dataclasses.fields(x)))
        return ("static", x)

    return leaves, walk(tree)


def unflatten(spec: tuple, leaves) -> object:
    r"""The tree of ``spec`` (from :func:`flatten`) with ``leaves`` in
    order."""
    it = iter(leaves)

    def build(s):
        kind = s[0]
        if kind == _TENSOR:
            return next(it)
        if kind == "static":
            return s[1]
        if kind in (tuple, list):
            return kind(build(v) for v in s[1])
        return kind(**{name: build(v) for name, v in s[1]})

    tree = build(spec)
    if next(it, None) is not None:
        raise ValueError("more leaves than the spec holds")
    return tree


def clone_tree(tree):
    """``tree`` with every tensor leaf cloned: a result the caller owns."""
    leaves, spec = flatten(tree)
    return unflatten(spec, [t.clone() for t in leaves])


def eager_reason(use_jit: bool, on_card: bool) -> Optional[str]:
    r"""``None`` when a pipeline call is captured and replayed as CUDA
    graphs, else why it runs eagerly: ``use_jit`` off, or inputs not on
    the card (a CPU run has nothing to capture). Every call is captured
    under autograd too."""
    if not use_jit:
        return "use_jit=False"
    if not on_card:
        return "inputs not on the card"
    return None


def needs_grad(*trees) -> bool:
    """Grad mode is on and a tensor of ``trees`` requires a gradient."""
    return torch.is_grad_enabled() and any(
        t.requires_grad for tree in trees for t in flatten(tree)[0])


def eager_reason_for(use_jit: bool, *trees) -> Optional[str]:
    """:func:`eager_reason` read from the tensors of ``trees``."""
    leaves = [t for tree in trees for t in flatten(tree)[0]]
    return eager_reason(use_jit, on_card=bool(leaves) and all(t.is_cuda for t in leaves))


def cache_key(name: str, options: tuple, leaves: List[torch.Tensor], spec: tuple) -> tuple:
    """The key of a call of path ``name`` with ``options`` on the inputs
    ``flatten`` gave as ``leaves`` and ``spec``."""
    return (name, options, spec, tuple((tuple(t.shape), t.dtype, t.device) for t in leaves))


def register_tally(name: str, tally: "collections.Counter[str]") -> None:
    """Have every capture and replay count on ``tally`` (counts by tag)
    as on the launch counters."""
    TALLIES[name] = tally


def _read_counters() -> Counts:
    counts: Counts = {(m.__name__, None): m.launches for m in LAUNCH_COUNTERS}
    for name, tally in TALLIES.items():
        counts.update(((name, tag), n) for tag, n in tally.items())
    return counts


def _counted_since(before: Counts) -> Counts:
    """What every counter counted since ``before`` (nonzero only)."""
    return {k: n - before.get(k, 0) for k, n in _read_counters().items()
            if n != before.get(k, 0)}


def _set_counters(counts: Counts) -> None:
    """Every counter put back to ``counts`` (from :func:`_read_counters`)."""
    for m in LAUNCH_COUNTERS:
        m.launches = counts[(m.__name__, None)]
    for name, tally in TALLIES.items():
        tally.clear()
        tally.update({tag: n for (owner, tag), n in counts.items() if owner == name})


def _add_counts(counts: Counts) -> None:
    """``counts`` (from :func:`_counted_since`) added to the counters."""
    modules = {m.__name__: m for m in LAUNCH_COUNTERS}
    for (owner, tag), n in counts.items():
        if owner in modules:
            modules[owner].launches += n
        else:
            TALLIES[owner][tag] += n


def _static_like(t: torch.Tensor, requires_grad: bool = False) -> torch.Tensor:
    """A static input for ``t``, outside the graphs' pool: later calls copy
    into it."""
    out = torch.empty(t.shape, dtype=t.dtype, device=t.device)
    return out.requires_grad_() if requires_grad else out


def _write(dst: torch.Tensor, src: torch.Tensor) -> None:
    r"""``dst.copy_(src)`` through ``dst.data``, which leaves ``dst``'s
    version counter alone: a tensor of a graph captured under autograd is
    rewritten as a replay rewrites it, unseen by autograd (a bumped version
    would make autograd rebuild the backward of the views of it). A
    static input given back to its own graph (an input that a body passed
    through, as the armed gate passes the anchor) is not copied onto
    itself."""
    if dst is not src:
        dst.data.copy_(src)


_ALIGN = 16  # bytes: each storage's place in an arena


def _span(t: torch.Tensor) -> Tuple[int, int]:
    """The bytes ``[start, end)`` of its storage that ``t`` reads."""
    start = t.storage_offset() * t.element_size()
    if t.numel() == 0:
        return start, start
    last = sum((n - 1) * st for n, st in zip(t.shape, t.stride()))
    return start, start + (last + 1) * t.element_size()


class _Arena:
    r"""The bytes of the storages that a captured forward's saved tensors
    live in (all but the static inputs', and only on the graph's device),
    laid end to end in one ``uint8`` buffer: a call gathers them into its
    own arena after the forward's replay and scatters its arena back before
    the backward's. Of each storage only the span its saved tensors and the
    outputs in it (``outputs``) read is kept, from a 16-byte boundary.
    ``views`` are those spans as flat bytes (with version counters of their
    own: the copies leave the saved tensors' alone), ``offsets`` each
    storage's place in the arena and the span's first byte."""

    def __init__(self, static_in: List[torch.Tensor], tensors: List[torch.Tensor],
                 outputs: List[torch.Tensor] = ()):
        device = static_in[0].device
        skip = {x.untyped_storage().data_ptr() for x in static_in}
        spans: Dict[int, list] = {}  # storage pointer -> [storage, first byte, end]
        for t in tensors:
            ptr = t.untyped_storage().data_ptr()
            lo, hi = _span(t)
            if t.device != device or hi == lo or ptr in skip:
                continue
            span = spans.setdefault(ptr, [t.untyped_storage(), lo, hi])
            span[1], span[2] = min(span[1], lo), max(span[2], hi)
        for t in outputs:  # an output in a kept storage becomes a view of the arena
            span = spans.get(t.untyped_storage().data_ptr())
            lo, hi = _span(t)
            if span is not None and hi > lo:
                span[1], span[2] = min(span[1], lo), max(span[2], hi)
        self.views: List[torch.Tensor] = []
        self.offsets: Dict[int, Tuple[int, int]] = {}
        total = 0
        for ptr, (st, lo, hi) in spans.items():
            lo -= lo % _ALIGN
            self.offsets[ptr] = (total, lo)
            self.views.append(torch.empty(0, dtype=torch.uint8, device=device).set_(
                st, lo, (hi - lo,), (1,)))
            total += -(-(hi - lo) // _ALIGN) * _ALIGN
        self.total = total

    def slices(self, arena: torch.Tensor) -> List[torch.Tensor]:
        return [arena[o:o + v.numel()] for (o, _), v in zip(self.offsets.values(), self.views)]

    def gather(self, device) -> torch.Tensor:
        """A new arena holding the spans."""
        arena = torch.empty(self.total, dtype=torch.uint8, device=device)
        if self.views:
            torch._foreach_copy_(self.slices(arena), self.views)
        return arena

    def scatter(self, arena: torch.Tensor) -> None:
        """The spans written back from ``arena``."""
        if self.views:
            torch._foreach_copy_(self.views, self.slices(arena))

    def view(self, arena: torch.Tensor, t: torch.Tensor) -> Optional[torch.Tensor]:
        """``t``'s counterpart in ``arena``, or None where its storage is
        not in it: a view, so it shares the arena's version counter."""
        place = self.offsets.get(t.untyped_storage().data_ptr())
        if place is None or t.numel() == 0:
            return None
        off, lo = place
        return arena.view(t.dtype).as_strided(
            t.shape, t.stride(), (off + _span(t)[0] - lo) // t.element_size())


class _Store:
    r"""The residuals of one conditional body of a forward captured without
    ``remat`` (the module docstring), kept only where its predicate held:
    ``capacity`` slots (``rows``, one row of ``layout.total`` bytes each)
    of the spans ``layout`` (an :class:`_Arena` of the tensors the body
    saved in the capture) reads, and ``count``, on the device, the slots
    the replays asked for since it last started. ``stage``, at least
    ``layout.total`` bytes, is where a push gathers the spans and a pop
    lands the slot, so that each moves its slot with one indexed copy and
    the spans with one multi-tensor copy, however many there are (the
    relocalization's body saves about 2,100 tensors). ``epoch`` numbers the
    counter's starts; ``held`` counts the calls that hold slots (their
    backward has not run), ``base`` the slots taken before the forward
    under way (the counter's last reading); ``warm`` is the key's warm-up's
    deferred predicates with this body's place among them (its frame's
    body ran eagerly, in its own autograd graph): what the next forward,
    which replays that frame too, needs besides."""

    def __init__(self, key: tuple, index: int, layout: "_Arena", rows: torch.Tensor,
                 count: torch.Tensor, stage: torch.Tensor):
        if rows.shape[1] != layout.total:
            raise RuntimeError("a conditional body saved other tensors in its capture than in "
                               "its warm-up, which sized its store")
        self.key, self.index, self.layout, self.capacity = key, index, layout, rows.shape[0]
        self.rows, self.count, self.stage = rows, count, stage
        self.open = False
        self.epoch, self.held, self.base = 0, 0, 0
        self.warm: Optional[Tuple["_Pending", int]] = None

    def push(self, branches: "_Branches", pred: torch.Tensor, layout: "_Arena") -> torch.Tensor:
        r"""Records, in the capture under way, after the body's node: the
        slot (the counter's value, a tensor of the graph), an IF node on
        "``pred`` and a free slot" that copies the spans of ``layout`` (the
        body's saved tensors; their storages are this store's layout's on
        the card) into it, and the counter's step where ``pred`` holds.
        Returns the slot."""
        if layout.views and layout.total != self.layout.total:
            raise RuntimeError("a conditional body saved other tensors than at its capture")
        slot = self.count.clone()
        if self.capacity and self.layout.total:
            ok = pred & (slot < self.capacity)

            def copy():
                stage = self.stage[:layout.total]
                torch._foreach_copy_(layout.slices(stage), layout.views)
                self.rows.index_copy_(0, slot.view(1), stage.view(1, -1))
                return []

            _conditional(branches, ok, copy, [])
        self.count.add_(pred)
        return slot

    def pop(self, slot: torch.Tensor) -> None:
        r"""``slot``'s bytes copied back into the body's saved tensors, in a
        body's VJP (inside its IF node, or in a warm-up where the call's
        forward ran the body)."""
        if not (self.capacity and self.layout.total):
            return
        stage = self.stage[:self.layout.total]
        torch.index_select(self.rows, 0, slot.clamp(max=self.capacity - 1).view(1),
                           out=stage.view(1, -1))
        torch._foreach_copy_(self.layout.views, self.layout.slices(stage))


class _Kept:
    r"""A forward captured without ``remat`` (the key ``key``, its static
    inputs ``static_in``): the :class:`_Store` of each conditional body by
    its place among the body's conditionals, and what each store is made
    of before the capture, outside the graphs' pool (a graph captured
    later may use that pool's free memory as scratch, and a store outlives
    its forward): its counter (``counts``, zeroed: no kernel of the graph
    sets it) and its slots (``rows``, ``capacity`` by the calls of its key
    before, each of the bytes the warm-up's body saved, ``warm``), and one
    ``stage`` the bodies' copies share (their nodes run one after another:
    the largest slot of a store with a capacity); and the
    storages of the static inputs that a body saved (``inputs``: the call
    keeps those inputs, as the frame's)."""

    def __init__(self, graphs: "FrameGraphs", key: tuple, static_in: List[torch.Tensor],
                 leaves: List[torch.Tensor], warm: Dict[int, List[torch.Tensor]]):
        self.graphs, self.key, self.static_in = graphs, key, static_in
        device = static_in[0].device
        self.counts, self.rows = {}, {}
        for index, saved in warm.items():
            self.counts[index] = torch.zeros((), dtype=torch.int64, device=device)
            self.rows[index] = torch.empty(
                (graphs._capacity.get((key, index), 0), _Arena(leaves, saved).total),
                dtype=torch.uint8, device=device)
        self.stage = torch.empty(max((r.shape[1] for r in self.rows.values() if r.shape[0]),
                                     default=0), dtype=torch.uint8, device=device)
        self.stores: Dict[int, _Store] = {}
        self.inputs: set = set()

    def push(self, branches: "_Branches", index: int, pred: torch.Tensor,
             saved: List[torch.Tensor]) -> Tuple[_Store, torch.Tensor]:
        """The store of conditional ``index``, and its slot for ``saved``
        (the tensors its body saved) where ``pred`` holds
        (:meth:`_Store.push`)."""
        ins = {x.untyped_storage().data_ptr() for x in self.static_in}
        self.inputs.update(p for p in (t.untyped_storage().data_ptr() for t in saved) if p in ins)
        layout = _Arena(self.static_in, saved)
        store = self.stores.get(index)
        if store is None:
            store = self.stores[index] = _Store(self.key, index, layout, self.rows[index],
                                                self.counts[index], self.stage)
        return store, store.push(branches, pred, layout)


class _Branches:
    r"""What :func:`when` records in one warm-up (``capturing`` False) or
    capture of a frame body: each conditional's predicate and what its body
    counted on every counter (taken back from the counters). ``owner`` is
    the :class:`FrameGraphs` whose conditional bodies' stream and pool
    (:meth:`FrameGraphs._branch_resources`) the bodies use on ``device``.
    ``kept`` is the :class:`_Kept` of a forward captured without ``remat``
    (else None): its bodies' residuals go to their stores; ``saves``, in
    such a forward's warm-up, the tensors each body saved, by place (they
    size its store). ``took``, in
    the warm-up of such a forward's backward, is which of its call's
    conditionals ran (read after the forward), by place."""

    def __init__(self, capturing: bool, owner: "FrameGraphs" = None, device=None):
        self.capturing = capturing
        self.owner = owner
        self.device = device
        self.kept: Optional[_Kept] = None
        self.saves: Optional[Dict[int, List[torch.Tensor]]] = None
        self.took: Optional[List[bool]] = None
        self.preds: List[torch.Tensor] = []
        self.counts: List[Counts] = []


_RECORDING: List[_Branches] = []  # the warm-up or capture under way, innermost last
# how a captured conditional node is made on the card (the only route:
# torch 2.11.0+cu128 has no CUDAGraph.begin_capture_to_if_node)
CONDITIONAL_ROUTE = "gradslam_torch/ops/csrc/conditional.cu (gradslam_if_begin, gradslam_if_end)"


@contextlib.contextmanager
def _recording(branches: _Branches):
    _RECORDING.append(branches)
    try:
        yield branches
    finally:
        _RECORDING.pop()


def when(pred: torch.Tensor, body: Callable, args: tuple,
         outs: List[torch.Tensor]) -> List[torch.Tensor]:
    r"""``jax.lax.cond(pred, lambda: body(*args), lambda: outs)`` inside a
    frame body that :class:`FrameGraphs` warms up and captures: ``outs``,
    tensors made before the call and holding the values that pass through,
    take what ``body(*args)`` returns (one tensor each) where the 0-dim bool
    ``pred`` on the device is true. Returns the result: ``outs`` themselves
    without autograd; under it (grad mode and a tensor of ``args`` or
    ``outs`` that requires a gradient) new tensors, the outputs of one
    differentiable :class:`_When` node.

    Captured, it is an IF conditional node (:func:`_if_node`) whose body
    graph holds ``body``'s kernels and the copies into the result, decided
    on the device on every replay. In the warm-up (the key's first call,
    under the sync debug mode "error") ``pred`` is not read: ``body`` runs
    whatever it holds, on the stream the captured body will use, and the
    result takes ``torch.where(pred, new, out)``, so both sides are warmed
    before the capture and the result is the eager bits. Either way what
    ``body`` counted on the launch counters and tallies is taken back and
    kept with ``pred``: :meth:`FrameGraphs.settle` adds it where ``pred``
    was true. Outside a warm-up or capture it raises: an eager caller
    decides on the host."""
    if not _RECORDING:
        raise RuntimeError("when() runs inside a frame body that FrameGraphs warms up or "
                           "captures; an eager caller branches on the host")
    branches = _RECORDING[-1]
    before = _read_counters()
    try:
        if needs_grad(args, outs):
            leaves, spec = flatten(args)
            outs = list(_When.apply(pred, body, spec, len(outs), *outs, *leaves))
        else:
            _conditional(branches, pred, lambda: body(*args), outs)
    finally:
        counted = _counted_since(before)
        _set_counters(before)
    branches.preds.append(pred)
    branches.counts.append(counted)
    return outs


class _When(torch.autograd.Function):
    r""":func:`when` under autograd: ``apply(pred, body, spec, n, *outs,
    *leaves)``, ``leaves`` the tensors of ``body``'s arguments (``spec``
    from :func:`flatten`). The forward runs ``body`` under grad on detached
    leaves inside the conditional, and keeps its autograd graph; the
    backward is the conditional of its VJP on the same predicate (the
    module docstring), recorded like the forward's on the warm-up or
    capture under way. The predicate is saved for the backward (a captured
    forward's arena keeps it); in a forward captured without ``remat``
    the tensors the body saves go to its store (:class:`_Kept`), and the
    slot is saved too."""

    @staticmethod
    def forward(ctx, pred, body, spec, n, *tensors):
        ctx.set_materialize_grads(False)
        outs, leaves = tensors[:n], tensors[n:]
        flags = [t.requires_grad for t in leaves]
        res = [o.clone() for o in outs]
        graph = {}  # the body's leaves and outputs, where it ran
        branches = _RECORDING[-1]
        # what the body saves, apart
        saved = None if branches.kept is None and branches.saves is None else []

        def run():
            xs = [t.detach().requires_grad_(f) for t, f in zip(leaves, flags)]
            hooks = contextlib.nullcontext() if saved is None else _recording_saved(saved)
            with torch.enable_grad(), hooks:
                new = flatten(body(*unflatten(spec, xs)))[0]
            graph["xs"], graph["new"] = xs, new
            return [t.detach() for t in new]

        _conditional(branches, pred, run, res)
        ctx.store, ctx.index, keep = None, len(branches.preds), [pred]
        if branches.kept is not None:
            ctx.store, slot = branches.kept.push(branches, ctx.index, pred, _alive(saved))
            keep.append(slot)
        elif saved is not None:
            branches.saves[ctx.index] = _alive(saved)
        ctx.save_for_backward(*keep)
        ctx.graph, ctx.n = graph, n
        ctx.like = [(t.shape, t.dtype, t.device) if f else None for t, f in zip(leaves, flags)]
        ctx.mark_non_differentiable(*(r for r in res if not r.is_floating_point()))
        return tuple(res)

    @staticmethod
    def backward(ctx, *grads):
        if not _RECORDING:
            raise RuntimeError("the backward of a when() under autograd runs inside the "
                               "backward that FrameGraphs warms up or captures")
        branches, (pred, *slot) = _RECORDING[-1], ctx.saved_tensors
        through = [None if g is None else torch.where(pred, -0.0, g) for g in grads]
        if ctx.store is not None and not branches.capturing:
            # a warm-up runs a VJP whatever its predicate, but where this call's
            # forward did not run the body, its tensors hold another call's bytes
            # (or what the pool held: a capture runs nothing), not residuals to
            # run on: the VJP gives nothing there, as eagerly
            if branches.took is None:
                raise RuntimeError("a forward captured without remat is settled "
                                   "(FrameGraphs.settle) before its backward")
            if not branches.took[ctx.index]:
                return (None, None, None, None, *through, *[None] * len(ctx.like))
        want = [j for j, like in enumerate(ctx.like) if like is not None]
        sel = [i for i, g in enumerate(grads) if g is not None]
        got: List[Optional[torch.Tensor]] = [None] * len(ctx.like)
        if want and sel:
            bufs = [torch.full(ctx.like[j][0], -0.0, dtype=ctx.like[j][1], device=ctx.like[j][2])
                    for j in want]

            def run():  # the body's VJP, on the body's stream
                if ctx.store is not None:  # this call's residuals back in the body's
                    ctx.store.pop(slot[0])
                xs, new = ctx.graph["xs"], ctx.graph["new"]
                live = [i for i in sel if new[i].requires_grad]
                if not live:
                    return [None] * len(want)
                # a captured forward's body graph serves every replay's backward
                return list(torch.autograd.grad(
                    [new[i] for i in live], [xs[j] for j in want], [grads[i] for i in live],
                    retain_graph=ctx.store is not None, allow_unused=True))

            before = _read_counters()
            try:
                wrote = _conditional(branches, pred, run, bufs)
            finally:
                counted = _counted_since(before)
                _set_counters(before)
            branches.preds.append(pred)
            branches.counts.append(counted)
            for j, buf, w in zip(want, bufs, wrote):
                got[j] = buf if w else None
        return (None, None, None, None, *through, *got)


def _conditional(branches: _Branches, pred: torch.Tensor, body: Callable,
                 outs: List[torch.Tensor]) -> List[bool]:
    """``body()``'s results written into ``outs`` where ``pred`` holds, as
    the recording under way runs a conditional: an IF node in a capture,
    :func:`_select` in a warm-up. A None result writes nothing. Returns
    which of ``outs`` the body writes."""
    if branches.capturing:
        return _if_node(branches, pred, body, outs)
    return _select(branches.owner._branch_resources(branches.device)[0], pred, body, outs)


def _select(stream, pred: torch.Tensor, body: Callable, outs: List[torch.Tensor]) -> List[bool]:
    """:func:`_conditional` in a warm-up: ``body()`` on ``stream`` and
    ``outs`` chosen by ``pred`` there, the caller's stream waiting for it."""
    current = torch.cuda.current_stream(pred.device)
    stream.wait_stream(current)
    with torch.cuda.stream(stream):
        new = list(body())
        for out, t in zip(outs, new):
            if t is not None:
                out.copy_(torch.where(pred, t, out))
    current.wait_stream(stream)
    return [t is not None for t in new]


def _pool_hooks() -> Tuple[Callable, Callable]:
    """torch's allocator hooks that route the current stream's allocations
    to a pool until ended."""
    begin = getattr(torch._C, "_cuda_beginAllocateCurrentStreamToPool", None)
    end = getattr(torch._C, "_cuda_endAllocateToPool", None)
    if begin is None or end is None:
        raise RuntimeError(
            f"torch {torch.__version__} lacks _cuda_beginAllocateCurrentStreamToPool or "
            "_cuda_endAllocateToPool: a captured conditional node's body cannot allocate "
            "into a graph pool")
    return begin, end


def _if_node(branches: _Branches, pred: torch.Tensor, body: Callable,
             outs: List[torch.Tensor]) -> List[bool]:
    r"""An IF node in the graph the current stream captures, holding
    ``body()`` and its copies into ``outs`` (a None result writes nothing;
    returns which of ``outs`` it writes): ``gradslam_if_begin``
    (``ops/csrc/conditional.cu``) adds the node and the kernel that sets
    its handle from ``pred``, and starts capturing the owner's branch
    stream into the node's body; the body runs on that stream with its
    allocations routed to the owner's branch pool (an entry holds a
    reference to the pool, which the owner gives back when it goes);
    ``gradslam_if_end`` closes it. A CUDA error raises with its name."""
    from ..ops._build import load_library

    lib = load_library()
    begin, end = _pool_hooks()
    owner = branches.owner
    stream, pool = owner._branch_resources(branches.device)
    device = pred.device.index if pred.device.index is not None else torch.cuda.current_device()
    capture = torch.cuda.current_stream(pred.device).cuda_stream
    body_stream = stream.cuda_stream

    def check(err: int, what: str) -> None:
        if err:
            raise RuntimeError(f"{what} failed: {lib.gradslam_cuda_error(err).decode()}")

    check(lib.gradslam_if_begin(capture, pred.data_ptr(), body_stream),
          "opening a CUDA graph conditional node (gradslam_if_begin)")
    try:
        with torch.cuda.stream(stream):
            begin(device, pool)
            owner._branch_pool_refs[1] += 1
            try:
                new = list(body())
                for out, t in zip(outs, new):
                    if t is not None:
                        out.copy_(t)
            finally:
                end(device, pool)
    finally:
        err = lib.gradslam_if_end(body_stream)
    check(err, "closing a CUDA graph conditional node (gradslam_if_end)")
    return [t is not None for t in new]


class CapturedCall:
    r"""One captured frame body: the graph, its static inputs and outputs,
    the output structure, what its capture counted on each counter
    (:data:`Counts`, nonzero only) outside its conditional nodes, and each
    conditional node's predicate (a tensor of the graph) and what its body
    counted (:func:`when`)."""

    def __init__(self, graph, static_in: List[torch.Tensor],
                 static_out: List[torch.Tensor], out_spec: tuple, counts: Counts,
                 preds: List[torch.Tensor] = (), branch_counts: List[Counts] = ()):
        self.graph = graph
        self.static_in = static_in
        self.static_out = static_out
        self.out_spec = out_spec
        self.counts = counts
        self.preds = list(preds)
        self.branch_counts = list(branch_counts)

    def run(self, leaves: List[torch.Tensor]) -> None:
        """``leaves`` copied into the static inputs, then a replay."""
        for dst, src in zip(self.static_in, leaves):
            _write(dst, src)
        self.graph.replay()
        _add_counts(self.counts)

    def __call__(self, leaves: List[torch.Tensor]):
        self.run(leaves)
        return unflatten(self.out_spec, self.static_out)


class _Backward(CapturedCall):
    r"""A captured backward for one set of output gradients: its static
    inputs are the output gradients, its static outputs the input gradients
    of the inputs that got one (``present``); with remat, its conditionals'
    predicates and body counts (the recompute's and their VJPs')."""

    def __init__(self, graph, static_grads, grads_in, present, counts,
                 preds=(), branch_counts=()):
        super().__init__(graph, static_grads, grads_in, (), counts, preds, branch_counts)
        self.present = present

    def __call__(self, grads: List[torch.Tensor]) -> List[Optional[torch.Tensor]]:
        self.run(grads)
        it = iter(self.static_out)
        return [next(it).clone() if p else None for p in self.present]


class _GradEntry:
    r"""The graphs of one key under autograd. ``diff`` marks the outputs
    that carry a gradient, ``through`` the outputs that are an input
    returned as it came (that input's index, else None), ``backward`` the
    captured backwards by the set of output gradients they take. With
    ``remat=False`` also the captured forward (``forward``, a
    :class:`CapturedCall` whose ``static_in`` are leaves, with its
    conditionals' predicates), the :class:`_Arena` of its saved tensors
    outside its conditional bodies, the :class:`_Store` of each body
    (``stores``), and ``restore_in``, the static inputs whose storages hold
    saved tensors; with ``remat=True`` the recompute's leaves
    (``backward_in``)."""

    def __init__(self, out_spec: tuple, diff: Tuple[bool, ...],
                 through: Tuple[Optional[int], ...]):
        self.out_spec = out_spec
        self.diff = diff
        self.through = through
        self.backward: Dict[tuple, _Backward] = {}
        self.forward: Optional[CapturedCall] = None
        self.arena: Optional[_Arena] = None
        self.stores: List[_Store] = []
        self.restore_in: List[int] = []
        self.backward_in: Optional[List[torch.Tensor]] = None


class _Saved:
    """A tensor autograd saved, as :func:`_recording_saved` packs it."""

    __slots__ = ("tensor", "__weakref__")

    def __init__(self, tensor: torch.Tensor):
        self.tensor = tensor


def _recording_saved(saved: list):
    """Saved-tensor hooks that pack every tensor autograd saves (detached:
    no reference cycle through a saved output) in a :class:`_Saved` and
    append a weak reference to it to ``saved``: see :func:`_alive`."""
    def pack(t):
        held = _Saved(t.detach())
        saved.append(weakref.ref(held))
        return held

    return torch.autograd.graph.saved_tensors_hooks(pack, lambda held: held.tensor)


def _alive(saved: list) -> List[torch.Tensor]:
    """The tensors of ``saved`` (weak references from
    :func:`_recording_saved`) whose nodes are alive. Once the body has
    returned those are the nodes its outputs' backward reaches: a node off
    that graph (a branch whose result is dropped or read without a
    gradient) is freed with what it saved, as eagerly."""
    return [held.tensor for held in (ref() for ref in saved) if held is not None]


class _GradCall:
    r"""One call of :meth:`FrameGraphs.grad`: the key, the body and its
    input structure, and, once the forward ran, the output structure and
    the forward's deferred predicates (``decided``, a :class:`_Pending`,
    None without conditionals), which with ``remat`` its backward's must
    equal; ``read`` settles the backward's. A replayed forward without
    ``remat`` notes each of its key's stores with the counter's start
    (``epochs``), and holds its slots there until its backward has run, it
    is freed, or its forward's read grew a store (``claims``; then
    ``lost``: the caller runs that forward again)."""

    def __init__(self, graphs: "FrameGraphs", key: tuple, fn: Callable, spec: tuple,
                 flags: Tuple[bool, ...], remat: bool, read: Callable):
        self.graphs, self.key, self.fn, self.spec = graphs, key, fn, spec
        self.flags, self.remat, self.read = flags, remat, read
        self.entry: Optional[_GradEntry] = None
        self.warm = False  # the warm-up's own autograd graph holds the backward
        self.decided: Optional[_Pending] = None
        self.epochs: List[Tuple[_Store, int]] = []
        self.claims: List[_Store] = []
        self.lost = False

    def body(self, leaves: List[torch.Tensor]) -> List[torch.Tensor]:
        return flatten(self.fn(*unflatten(self.spec, leaves)))[0]

    def leaves_for_grad(self, leaves) -> List[torch.Tensor]:
        """Detached aliases of ``leaves``, the float ones that need a
        gradient made leaves that require one."""
        return [t.detach().requires_grad_(f) for t, f in zip(leaves, self.flags)]

    # -- forward ---------------------------------------------------------
    def forward(self, leaves: List[torch.Tensor]) -> Tuple[List[torch.Tensor], list]:
        r"""The outputs (tensors the call owns, or, for an input the body
        returns as it came, that input: autograd makes it a view) and the
        tensors its backward reads: with remat the inputs; without, the
        inputs whose storages hold saved tensors and the arena (or, for a
        warm-up, the leaves and outputs of its autograd graph)."""
        table = self.graphs._remat if self.remat else self.graphs._kept
        self.entry = table.get(self.key)
        if self.entry is None:
            return self._first(leaves, table)
        e = self.entry
        if self.remat:
            pending = len(self.graphs._pending)
            out = self.graphs._replay_frame(self.key[:-1], self.fn, self.spec, leaves)
            if len(self.graphs._pending) > pending:
                self.decided = self.graphs._pending[-1]
            return [o.clone() if j is None else leaves[j]
                    for o, j in zip(flatten(out)[0], e.through)], list(leaves)
        fwd = e.forward
        for store in e.stores:
            self.graphs._open(store)
        fwd.run(leaves)
        self.graphs._replayed(self.key[0])
        self.decided = self.graphs._defer(fwd.preds, fwd.branch_counts)
        if e.stores:
            self.epochs = [(store, store.epoch) for store in e.stores]
            self.claims = list(e.stores)
            for store in self.claims:
                store.held += 1
            weakref.finalize(self, _release, self.claims)
            self.graphs._claimed.append(self)
        arena = e.arena.gather(leaves[0].device)  # this frame's saved tensors
        self.graphs.kept_bytes += arena.numel()
        outs = []
        for o, j in zip(fwd.static_out, e.through):
            if j is not None:
                outs.append(leaves[j])
                continue
            mine = e.arena.view(arena, o)  # an output autograd saved is a view of the arena
            outs.append(o.detach().clone() if mine is None else mine)
        return outs, [*(leaves[j] for j in e.restore_in), arena]

    def _first(self, leaves, table) -> Tuple[List[torch.Tensor], list]:
        """The warm-up: the body under grad on aliases of the inputs, on the
        side stream with synchronisation an error. It is this call's
        result; without remat its autograd graph is this call's backward,
        and the forward is captured from it."""
        xs = self.leaves_for_grad(leaves)
        device = leaves[0].device
        with _recording(_Branches(False, self.graphs, device)) as warmed, torch.enable_grad():
            warmed.saves = None if self.remat else {}
            outs, out_spec = self.graphs._warm(
                lambda: flatten(self.fn(*unflatten(self.spec, xs))), device)
        self.decided = self.graphs._defer(warmed.preds, warmed.counts)
        place = {id(x): j for j, x in enumerate(xs)}
        through = tuple(place.get(id(o)) for o in outs)
        self.entry = _GradEntry(out_spec, tuple(o.requires_grad for o in outs), through)
        if self.remat:
            table[self.key] = self.entry
            return [o.detach().clone() if j is None else leaves[j]
                    for o, j in zip(outs, through)], list(leaves)
        self._capture_forward(leaves, warmed.saves)
        for store in self.entry.stores:
            store.warm = (self.decided, store.index)
        table[self.key] = self.entry
        self.warm = True
        inputs = set(t.untyped_storage().data_ptr() for t in leaves)
        # another output in an input's storage (a view of it) is copied
        owned = [leaves[j] if j is not None
                 else o.detach().clone() if o.untyped_storage().data_ptr() in inputs
                 else o.detach() for o, j in zip(outs, through)]
        return owned, [*xs, *outs]

    def _capture_forward(self, leaves, warm: dict) -> None:
        """The forward captured under the saved-tensor hooks, with the
        stores of its conditional bodies (:class:`_Kept`; ``warm``, what
        each saved in the warm-up), opened for the forward under way."""
        static_in = [_static_like(t, f) for t, f in zip(leaves, self.flags)]
        for dst, src in zip(static_in, leaves):
            _write(dst, src)
        device = leaves[0].device
        kept = _Kept(self.graphs, self.key, static_in, leaves, warm)

        def captured():
            refs: list = []
            with torch.enable_grad(), _recording_saved(refs):
                outs = self.body(static_in)
            return outs, _alive(refs)

        with _recording(_Branches(True, self.graphs, device)) as branches:
            branches.kept = kept
            graph, (static_out, saved), counts = self.graphs._captured(
                self.key[0], "forward", "forward", captured, device)
        e = self.entry
        place = {id(x): j for j, x in enumerate(static_in)}
        if (tuple(o.requires_grad for o in static_out) != e.diff
                or tuple(place.get(id(o)) for o in static_out) != e.through):
            raise RuntimeError(f"the {self.key[0]!r} frame body's captured forward carries "
                               "gradients on other outputs, or passes other inputs through, "
                               "than its warm-up")
        e.forward = CapturedCall(graph, static_in, static_out, e.out_spec, counts,
                                 branches.preds, branches.counts)
        e.arena = _Arena(static_in, saved, static_out)
        e.stores = [kept.stores[i] for i in sorted(kept.stores)]
        for store in e.stores:  # for the forward under way, which replays the key next
            self.graphs._open(store)
        ins = {x.untyped_storage().data_ptr(): j for j, x in enumerate(static_in)}
        held = {t.untyped_storage().data_ptr() for t in saved} | kept.inputs
        e.restore_in = sorted(ins[p] for p in held if p in ins)

    # -- backward --------------------------------------------------------
    def backward(self, saved, grads) -> List[Optional[torch.Tensor]]:
        r"""The input gradients for the output gradients ``grads`` (None
        where an output got none); ``saved`` is what :meth:`forward`
        returned to keep."""
        e = self.entry
        diff = [i for i, d in enumerate(e.diff) if d]
        mask = tuple(grads[i] is not None for i in diff)
        sel = [i for i, m in zip(diff, mask) if m]
        g = [grads[i] for i in sel]
        want = [j for j, f in enumerate(self.flags) if f]
        if not sel or not want:
            return [None] * len(self.flags)
        if self.warm:  # this call's own autograd graph, from the warm-up
            xs, outs_w = saved[:len(self.flags)], saved[len(self.flags):]
            device = xs[0].device
            with _recording(_Branches(False, self.graphs, device)) as warmed:
                got = self.graphs._warm(lambda: list(torch.autograd.grad(
                    [outs_w[i] for i in sel], [xs[j] for j in want], g,
                    retain_graph=True, allow_unused=True)), device)
            self._decide_after_backward(warmed.preds, warmed.counts)
            return self._scatter(want, got)
        bwd = e.backward.get(mask)
        if self.remat:
            if bwd is None:
                return self._scatter(want, self._capture_backward_remat(mask, sel, want, saved, g))
            for dst, src in zip(e.backward_in, saved):
                _write(dst, src)
        else:
            if self.lost or any(store.epoch != epoch for store, epoch in self.epochs):
                raise RuntimeError(
                    f"the {self.key[0]!r} frame's conditional body residuals are gone: its "
                    "forward's read grew a store (FrameGraphs.settle, regrew: run the forward "
                    "again), or its backward ran before and a later forward took its slots")
            for j, src in zip(e.restore_in, saved):
                _write(e.forward.static_in[j], src)
            e.arena.scatter(saved[-1])  # this frame's saved tensors
            if bwd is None:
                return self._scatter(want, self._capture_backward_kept(mask, sel, want, g))
        self.graphs._replayed(self.key[0])
        got = bwd(g)
        self._decide_after_backward(bwd.preds, bwd.branch_counts)
        return self._scatter(want, got)

    def release(self) -> None:
        """The slots this call holds given back: its backward has run."""
        _release(self.claims)

    def _decide_after_backward(self, preds, counts) -> None:
        """The backward's predicates deferred, held to the forward's with
        ``remat`` (its recompute decides again; without, each VJP's node
        reads the forward's own predicate), and read with the other frames'
        after the backward's last frame."""
        pending = self.graphs._defer(preds, counts)
        if pending is not None:
            if self.remat:
                pending.expect = self.decided
            self.graphs._settle_after_backward(self.read)

    def _scatter(self, want, got) -> List[Optional[torch.Tensor]]:
        out: List[Optional[torch.Tensor]] = [None] * len(self.flags)
        for j, t in zip(want, got):
            out[j] = t
        return out

    def _backward_graph(self, mask, run, g) -> List[Optional[torch.Tensor]]:
        """Warm ``run`` (the backward under synchronisation as an error:
        its result is this call's), then capture it with static output
        gradients. The inputs that get a gradient are the capture's: a
        warm-up without ``remat`` skips the VJPs of the bodies its call's
        forward did not run, which a capture holds."""
        static_grads = [_static_like(t) for t in g]
        for dst, src in zip(static_grads, g):
            dst.copy_(src)
        device = static_grads[0].device
        with _recording(_Branches(False, self.graphs, device)) as warmed:
            warmed.took = self.decided and self.decided.took
            got = self.graphs._warm(lambda: run(static_grads), device)
        self._decide_after_backward(warmed.preds, warmed.counts)
        with _recording(_Branches(True, self.graphs, device)) as branches:
            graph, grads, counts = self.graphs._captured(
                self.key[0], "backward", "backward", lambda: run(static_grads), device)
        present = [t is not None for t in grads]
        self.entry.backward[mask] = _Backward(graph, static_grads,
                                              [t for t in grads if t is not None], present,
                                              counts, branches.preds, branches.counts)
        return got

    def _capture_backward_kept(self, mask, sel, want, g):
        e = self.entry
        fwd = e.forward

        def run(static_grads):
            return list(torch.autograd.grad(
                [fwd.static_out[i] for i in sel], [fwd.static_in[j] for j in want],
                static_grads, retain_graph=True, allow_unused=True))

        return self._backward_graph(mask, run, g)

    def _capture_backward_remat(self, mask, sel, want, leaves, g):
        e = self.entry
        if e.backward_in is None:
            e.backward_in = [_static_like(t, f) for t, f in zip(leaves, self.flags)]
        for dst, src in zip(e.backward_in, leaves):
            _write(dst, src)

        def run(static_grads):
            with torch.enable_grad():
                outs = self.body(e.backward_in)
                return list(torch.autograd.grad(
                    [outs[i] for i in sel], [e.backward_in[j] for j in want],
                    static_grads, allow_unused=True))

        return self._backward_graph(mask, run, g)


class _Pending:
    r"""One call's predicates deferred on the device (a copy: a replay
    overwrites the graph's), what each conditional's body counted, and,
    once :meth:`FrameGraphs.settle` read them, ``took``. A backward's
    ``expect`` is its forward's: the recompute must decide as the forward
    did."""

    __slots__ = ("preds", "counts", "took", "expect")

    def __init__(self, preds: torch.Tensor, counts: List[Counts]):
        self.preds, self.counts = preds, counts
        self.took: Optional[List[bool]] = None
        self.expect: Optional["_Pending"] = None


class _FrameFunction(torch.autograd.Function):
    r"""One frame of :meth:`FrameGraphs.grad`: ``apply(call, *leaves)``
    returns the output leaves and saves what the call's backward reads
    (:meth:`_GradCall.forward`)."""

    @staticmethod
    def forward(ctx, call: _GradCall, *leaves):
        ctx.set_materialize_grads(False)
        outs, keep = call.forward(list(leaves))
        ctx.call = call
        ctx.mark_non_differentiable(*(o for o, d in zip(outs, call.entry.diff) if not d))
        ctx.save_for_backward(*keep)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        with torch.no_grad():
            got = ctx.call.backward(list(ctx.saved_tensors), list(grads))
        ctx.call.release()
        return (None, *got)


def _release(claims: List[_Store]) -> None:
    """The slots of a call's stores (``claims``) given back, once."""
    for store in claims:
        store.held -= 1
    claims.clear()


def _release_pool(pool, refs: list) -> None:
    """The allocator's references to a conditional bodies' pool (``refs``:
    ``[device index, count]``) given back, so its memory can be freed."""
    device, n = refs
    refs[1] = 0
    for _ in range(n):
        torch._C._cuda_releasePool(device.index or 0, pool)


class FrameGraphs:
    r"""A pipeline's CUDA graphs, one for each key, sharing one memory pool
    and one capture stream; :meth:`clear` frees them and the pool.

    ``capture_s`` sums the seconds spent capturing (the warm-ups excluded),
    ``replays`` counts the replays and ``kept_bytes`` the bytes of the
    arenas that replayed forwards without ``remat`` gave their calls;
    ``by_key`` holds, for each key name (``'gate'``, ``'relocalize'``,
    ...), the graphs captured of each kind (``'frame'``, ``'forward'``,
    ``'backward'``), their capture seconds (``'capture_s'``) and the
    replays of any of them (``'replays'``). ``len()`` is the number of
    graphs, :meth:`counts` the number of each kind, :meth:`saved_bytes`
    the bytes the captured forwards' saved tensors live in.

    A body with conditionals (:func:`when`) leaves, at its warm-up and at
    each replay, its predicates on the device beside what each
    conditional's body counts; :meth:`settle` reads them all at once, and
    ``branch_launches`` tallies what it added to the counters (by counter:
    the launches inside conditional bodies). Under autograd a call's
    backward leaves its VJPs' predicates (with ``remat``, its recompute's
    too) the same way; they are settled once, by a callback on autograd's
    engine after the backward's last node, and with ``remat`` held to the
    forward's. Without ``remat`` :meth:`settle` also reads the conditional
    bodies' store counters (:class:`_Store`): ``pushed_bytes`` is what the
    bodies that ran in the forward it settled saved in their stores,
    :meth:`store_bytes` what the stores hold, ``regrew`` whether that read
    grew a store (the forward must run again) and ``regrows`` how often
    one did."""

    def __init__(self):
        self._entries: Dict[tuple, CapturedCall] = {}
        self._kept: Dict[tuple, _GradEntry] = {}  # under autograd, remat=False
        self._remat: Dict[tuple, _GradEntry] = {}  # under autograd, remat=True
        self._pool = None
        self._stream = None
        # the conditional nodes' bodies: their stream and pool, and the
        # references the allocator holds to that pool (one an entry)
        self._branch_stream = None
        self._branch_pool = None
        self._branch_pool_refs = [None, 0]  # [device index, references]
        # the calls' predicates on the device, until settled
        self._pending: List[_Pending] = []
        self._settle_task = None  # the backward pass whose settle is queued
        self.branch_launches: "collections.Counter" = collections.Counter()
        self.capture_s = 0.0
        self.replays = 0
        self.kept_bytes = 0
        self.by_key: Dict[str, collections.Counter] = collections.defaultdict(
            collections.Counter)
        # the conditional bodies' stores: capacity by (key, place), the stores
        # opened since the last settle and the calls that took slots in them,
        # and what the settles found
        self._capacity: Dict[Tuple[tuple, int], int] = {}
        self._opened: List[_Store] = []
        self._claimed: List[_GradCall] = []
        self.pushed_bytes = 0
        self.regrew = False
        self.regrows = 0

    def counts(self) -> Dict[str, int]:
        """The graphs of each kind: ``frame`` (no grad; with ``remat`` also
        the forward under autograd), ``forward`` (under autograd, residuals
        kept) and ``backward``."""
        grad = [*self._kept.values(), *self._remat.values()]
        return {"frame": len(self._entries),
                "forward": sum(e.forward is not None for e in grad),
                "backward": sum(len(e.backward) for e in grad)}

    def saved_bytes(self) -> int:
        """The bytes of the storages the captured forwards (without
        ``remat``) keep their saved tensors in: one frame's for each key."""
        return sum(e.arena.total + sum(s.layout.total for s in e.stores)
                   for e in self._kept.values() if e.arena is not None)

    def store_bytes(self) -> int:
        """The bytes the conditional bodies' stores hold (their slots)."""
        return sum(s.rows.numel() for e in self._kept.values() for s in e.stores)

    def __len__(self) -> int:
        return sum(self.counts().values())

    def clear(self) -> None:
        self._entries.clear()
        self._kept.clear()
        self._remat.clear()
        self._pool = self._stream = None
        self._pending.clear()
        self._settle_task = None
        self.branch_launches.clear()
        if self._branch_pool is not None:
            self._release_branch_pool()
        self._branch_pool = self._branch_stream = None
        self.capture_s = 0.0
        self.replays = 0
        self.kept_bytes = 0
        self.by_key.clear()
        self._capacity.clear()
        self._opened.clear()
        self._claimed.clear()
        self.pushed_bytes = 0
        self.regrew = False
        self.regrows = 0

    def __call__(self, name: str, fn: Callable, args: tuple, options: tuple = ()):
        r"""``fn(*args)``, from the graph of this call's key: replayed when
        the key has one, else run eagerly and captured. The result of a
        replay is the graph's static outputs (see the module docstring)."""
        leaves, spec = flatten(args)
        key = cache_key(name, options, leaves, spec)
        return self._replay_frame(key, fn, spec, leaves)

    def grad(self, name: str, fn: Callable, args: tuple, options: tuple = (),
             remat: bool = False, read: Callable = lambda flags: flags.tolist()):
        r"""``fn(*args)`` under autograd, its forward and backward replayed
        from graphs (the module docstring): the result is the caller's,
        later calls leave it alone. The key adds to :meth:`__call__`'s
        which inputs require a gradient. A body with conditionals
        (:func:`when`) defers its predicates as a no-grad call does (the
        caller settles them after its forward; without ``remat`` that read
        may ask for the forward again: ``regrew``); its backward's are
        settled with ``read`` once, after the backward's last frame, and
        with ``remat`` must equal the forward's."""
        leaves, spec = flatten(args)
        flags = tuple(t.requires_grad for t in leaves)
        key = cache_key(name, options, leaves, spec) + (flags,)
        call = _GradCall(self, key, fn, spec, flags, remat, read)
        outs = _FrameFunction.apply(call, *leaves)
        return unflatten(call.entry.out_spec, outs)

    def settle(self, read: Callable = lambda flags: flags.tolist()) -> List[List[bool]]:
        r"""One read (``read``, of one tensor) of the predicates of every
        body with conditionals (:func:`when`) warmed up or replayed since
        the last settle, and of the counters of the stores opened since
        (:class:`_Store`): each conditional's body counts are added to the
        counters where its predicate was true. Returns each such call's
        predicates, in order. A backward's recompute that decided otherwise
        than its forward raises.

        A store that was asked for more slots than it holds (by the
        forward settled and by the earlier ones whose calls hold theirs,
        counting the key's warm-up, whose frame the next forward replays)
        is sized to that from now on and its key's graphs are dropped, to
        be captured again with it at the key's next call; ``regrew`` says
        so (the forward settled lost those pushes and must run again: its
        calls give their slots back, and their backward raises), and
        ``regrows`` counts such reads."""
        if not self._pending:
            return []
        pending, self._pending = self._pending, []
        opened, self._opened = self._opened, []
        parts = [p.preds for p in pending]
        if opened:  # one read of the predicates and the counters
            parts = [t.long() for t in parts] + [s.count.view(1) for s in opened]
        flags = read(torch.cat(parts))
        i = 0
        for p in pending:
            p.took = [bool(x) for x in flags[i:i + len(p.counts)]]
            i += len(p.counts)
            for ran, c in zip(p.took, p.counts):
                if ran:
                    _add_counts(c)
                    self.branch_launches.update(c)
        for p in pending:
            if p.expect is not None and (p.expect.took is None
                                         or p.took[:len(p.expect.took)] != p.expect.took):
                raise RuntimeError(
                    f"a backward's recompute decided its conditionals {p.took} where its "
                    f"forward decided {p.expect.took}: the gradient would not be the forward's")
        self._size_stores(opened, [int(n) for n in flags[i:]])
        claimed, self._claimed = self._claimed, []
        if self.regrew:  # the forward settled runs again: its calls' slots go
            for call in claimed:
                call.lost = True
                call.release()
        return [p.took for p in pending]

    def _size_stores(self, stores: List[_Store], ran: List[int]) -> None:
        """Each of ``stores`` closed with its counter's reading ``ran`` (the
        slots taken since the counter started: ``base`` of them before this
        forward), and grown where that was more than it holds
        (:meth:`settle`)."""
        self.regrew = False
        if stores:
            self.pushed_bytes = 0
        for store, n in zip(stores, ran):
            store.open = False
            # the pushes past the capacity stored nothing
            self.pushed_bytes += max(min(n, store.capacity) - store.base, 0) * store.layout.total
            store.base = n
            if store.warm is not None:
                pending, index = store.warm
                store.warm = None
                n += bool(pending.took and pending.took[index])
            if n <= store.capacity:
                continue
            self._capacity[store.key, store.index] = n
            entry = self._kept.get(store.key)
            if entry is not None and store in entry.stores:
                del self._kept[store.key]
            self.regrew = True
        self.regrows += self.regrew

    def _open(self, store: _Store) -> None:
        """``store`` opened for the forward under way, at the first call of
        its key since the last settle: its counter started again where no
        call holds a slot, else the forward takes the slots after the
        held ones."""
        if not store.open:
            if not store.held:
                store.count.zero_()
                store.epoch += 1
                store.base = 0
            store.open = True
            self._opened.append(store)

    def _defer(self, preds: List[torch.Tensor], counts: List[Counts]) -> Optional[_Pending]:
        """A call's predicates, copied on the device (a replay overwrites
        the graph's), kept with what each body counts until :meth:`settle`;
        None without conditionals."""
        if not preds:
            return None
        self._pending.append(_Pending(torch.stack(preds), counts))
        return self._pending[-1]

    def _settle_after_backward(self, read: Callable) -> None:
        """:meth:`settle` with ``read`` queued once on the backward pass
        under way, to run after its last node: one read for the backward's
        frames."""
        task = torch._C._current_graph_task_id()
        if task != self._settle_task:
            self._settle_task = task
            torch.autograd.Variable._execution_engine.queue_callback(lambda: self.settle(read))

    def _replay_frame(self, key: tuple, fn: Callable, spec: tuple,
                      leaves: List[torch.Tensor]):
        entry = self._entries.get(key)
        if entry is not None:
            self._replayed(key[0])
            out = entry(leaves)
            self._defer(entry.preds, entry.branch_counts)
            return out
        return self._capture(key, fn, leaves, spec)

    def _side_stream(self, device):
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
            self._pool = torch.cuda.graph_pool_handle()
        return self._stream

    def _branch_resources(self, device) -> tuple:
        """The stream the conditional bodies (:func:`when`) run on and the
        pool their captures allocate from, made at the first such body."""
        if self._branch_stream is None:
            self._branch_stream = torch.cuda.Stream(device)
            self._branch_pool = torch.cuda.graph_pool_handle()
            self._branch_pool_refs[:] = [device, 0]
            # the allocator's references to the pool go with this cache (its
            # graphs, which read the pool's memory, go with it too)
            weakref.finalize(self, _release_pool, self._branch_pool,
                             self._branch_pool_refs).atexit = False
        return self._branch_stream, self._branch_pool

    def _release_branch_pool(self) -> None:
        _release_pool(self._branch_pool, self._branch_pool_refs)

    def _warm(self, fn: Callable, device=None):
        r"""``fn()`` on the side stream with synchronisation an error: a
        warm-up, whose result is the caller's."""
        stream = self._side_stream(device)
        current = torch.cuda.current_stream(device)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                result = fn()
            finally:
                torch.cuda.set_sync_debug_mode(mode)
        current.wait_stream(stream)
        return result

    def _graph(self, fn: Callable, device):
        r"""``fn()`` captured into a CUDA graph on the side stream, in the
        shared pool: ``(graph, what fn returned)``. A replay runs what
        ``fn`` launched and rewrites the tensors it returned.

        Python's garbage collector is off during the capture: a collection
        there could free an unreachable pipeline's graphs, and destroying a
        graph is not permitted while a stream captures (it breaks the
        capture)."""
        graph = torch.cuda.CUDAGraph()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self._pool, stream=self._side_stream(device)):
                out = fn()
        finally:
            if collecting:
                gc.enable()
        torch.cuda.current_stream(device).wait_stream(self._stream)
        return graph, out

    def _captured(self, name: str, kind: str, what: str, fn: Callable, device):
        r""":meth:`_graph` of ``fn``, a graph of ``kind`` (``'frame'``,
        ``'forward'``, ``'backward'``) for the key ``name``, with what its
        capture counted taken back and returned: ``(graph, result,
        counts)``. A failed capture raises."""
        t0 = time.perf_counter()
        before = _read_counters()
        try:
            graph, out = self._graph(fn, device)
        except RuntimeError as err:
            raise RuntimeError(
                f"CUDA graph capture of the {name!r} frame {what} failed: {err}") from err
        finally:
            counts = _counted_since(before)
            _set_counters(before)
        secs = time.perf_counter() - t0
        self.capture_s += secs
        self.by_key[name][kind] += 1
        self.by_key[name]["capture_s"] += secs
        return graph, out, counts

    def _replayed(self, name: str) -> None:
        self.replays += 1
        self.by_key[name]["replays"] += 1

    def _capture(self, key: tuple, fn: Callable, leaves: List[torch.Tensor], spec: tuple):
        device = leaves[0].device
        # the static inputs, outside the pool: the next call copies into them
        static_in = [_static_like(t) for t in leaves]

        def warm():
            for dst, src in zip(static_in, leaves):
                dst.copy_(src)
            return fn(*unflatten(spec, static_in))

        with _recording(_Branches(False, self, device)) as warmed:
            result = self._warm(warm, device)
        self._defer(warmed.preds, warmed.counts)
        with _recording(_Branches(True, self, device)) as branches:
            graph, out, counts = self._captured(
                key[0], "frame", f"body (options {key[1]})",
                lambda: fn(*unflatten(spec, static_in)), device)
        static_out, out_spec = flatten(out)
        self._entries[key] = CapturedCall(graph, static_in, static_out, out_spec, counts,
                                          branches.preds, branches.counts)
        return result
