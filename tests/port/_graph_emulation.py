"""The CUDA-graph capture emulated on the CPU, for the tests of the port's
``use_jit`` (``gradslam_torch/utils/graphs.py``): in the test process and
in the spawned gloo worlds (``tests/port/_parallel_worlds.py``).

:func:`emulate` makes calls on CPU tensors count as on the card and
replaces ``torch.cuda``'s capture calls by stand-ins: a captured body runs
once (the capture), and a replay runs it again and writes what it returns
into the same static tensors (outputs, saved residuals, gradients), as a
replay rewrites its graph's memory. A replay runs its body's kernels and
collectives (under gloo every rank replays in step) but counts nothing:
every counter of ``graphs`` (the kernels' launches, the collectives' bytes
and calls) is put back after it, as on the card.

A conditional node (``graphs.when`` in a capture, ``graphs._if_node`` on
the card) is emulated too: at the capture its body runs whatever the
predicate holds, as the card captures it, but writes nothing; at a replay
it runs, and writes into its outputs, only where the predicate reads true
(the emulation reads it; the port never does). That holds for the
conditionals of a differentiable ``when`` in a captured backward too: the
VJP's node runs only where its predicate reads true, so a body that did not
run leaves no residuals for it to read. In a forward captured without
remat the node that pushes a body's residuals to its store runs, as on the
card, after the body's and only where its own predicate reads true; a
replay's body saves fresh tensors, which that node copies. A node reports the outputs its
capture wrote (a body's None results write nothing), as on the card, where
a replay runs no Python. Each replay writes its predicates into the
captured ones, which ``FrameGraphs`` keeps beside the replay, and poisons
them with the graph's other pool tensors.

:func:`count_at_dispatchers` raises the kernels' launch counters where the
card would launch them: on the CPU no wrapper launches.
"""

import contextlib
import types

import torch

from gradslam_torch.odometry import icputils
from gradslam_torch.ops import knn_cuda, scatter_cuda
from gradslam_torch.parallel import map_sharded as map_sharded_module
from gradslam_torch.slam import health as health_module
from gradslam_torch.slam import icpslam as icpslam_module
from gradslam_torch.structures import pointclouds as pointclouds_module
from gradslam_torch.utils import graphs
from gradslam_torch.utils.graphs import FrameGraphs, eager_reason, flatten


class StandInGraph:
    """A graph whose replay only counts."""

    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def fake_cuda(monkeypatch, graph_cls=StandInGraph):
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
                        lambda g, pool=None, stream=None, capture_error_mode="global":
                        contextlib.nullcontext())


_REAL_STATIC_LIKE = graphs._static_like
_OUTSIDE_POOL = set()  # storages of the static tensors made outside the graphs' pool


def _static_outside_pool(t, requires_grad=False):
    out = _REAL_STATIC_LIKE(t, requires_grad)
    _OUTSIDE_POOL.add(out.untyped_storage().data_ptr())
    return out


def _one_per_run(t):
    """``t``'s elements with an expanded (stride-0) dimension taken once."""
    return t.data[tuple(0 if st == 0 else slice(None) for st in t.stride())]


def _poison(t):
    if t.untyped_storage().data_ptr() in _OUTSIDE_POOL or t.numel() == 0:
        return
    if t.dtype.is_floating_point:
        _one_per_run(t).fill_(float("nan"))
    else:
        _one_per_run(t).fill_(True if t.dtype == torch.bool else -7)


_REPLAYING = [False]  # whether a conditional node runs in an emulated replay
# the emulated graph being captured or replayed: which outputs each of its
# conditional nodes writes (from the capture) and the next node's place
_ACTIVE = []


def emulated_if_node(branches, pred, body, outs):
    """graphs._if_node on the CPU: the capture runs ``body`` and writes
    nothing; a replay runs it where ``pred`` reads true, as the card does,
    and writes what it returns into ``outs`` (a None result writes
    nothing). Returns which of ``outs`` the node writes, as its capture
    found."""
    nodes = _ACTIVE[-1]
    if not _REPLAYING[0]:
        wrote = [value is not None for value in body()]
        nodes["writes"].append(wrote)
        return wrote
    wrote = nodes["writes"][nodes["next"]]
    nodes["next"] += 1
    if bool(pred):
        for out, value in zip(outs, body()):
            if value is not None:
                out.copy_(value)
    return wrote


def emulated_graph(self, fn, device):
    """FrameGraphs._graph on the CPU: ``fn`` runs once (the capture) and the
    tensors it returns are the static ones; a replay runs ``fn`` again and
    writes what it returns into them (outputs, saved residuals, gradients),
    as a replay rewrites its graph's memory, unseen by autograd.

    The graphs of a ``FrameGraphs`` share one pool, so a graph captured
    later may hold its outputs in memory that an earlier graph uses as
    scratch: a replay poisons the pool tensors of every graph captured after
    it (NaN, -7, True; static inputs, made outside the pool, are left
    alone). A caller that reads a graph's outputs after another graph's
    replay reads poison, as it reads garbage on the card. A body's
    conditional nodes' predicates are graph tensors too: a replay writes
    them, and poisons them in later graphs (but not those of an earlier
    graph that a later one reads)."""
    recording = graphs._RECORDING[-1] if graphs._RECORDING else None
    first = len(recording.preds) if recording is not None else 0
    nodes = {"writes": [], "next": 0}
    _ACTIVE.append(nodes)
    try:
        out = fn()
    finally:
        _ACTIVE.pop()
    preds = list(recording.preds[first:]) if recording is not None else []
    static = flatten(out)[0]
    order = self.__dict__.setdefault("_emulated_order", [])
    later = len(order) + 1
    order.append(static + preds)

    def replay():
        before = graphs._read_counters()  # a replay runs no wrapper and no helper
        _REPLAYING[0] = True
        nodes["next"] = 0
        _ACTIVE.append(nodes)
        fresh_branches = graphs._Branches(True)
        # a forward captured without remat pushes its bodies' residuals to
        # the stores of its capture
        fresh_branches.kept = recording.kept if recording is not None else None
        try:
            with torch.no_grad(), graphs._recording(fresh_branches):
                fresh = flatten(fn())[0]
        finally:
            _REPLAYING[0] = False
            _ACTIVE.pop()
        graphs._set_counters(before)
        with torch.no_grad():
            for dst, src in zip(static + preds, fresh + fresh_branches.preds):
                _one_per_run(dst).copy_(_one_per_run(src))
            # a later graph's tensor that an earlier graph holds (the
            # forward's predicate, read by a backward's node without remat)
            # is that graph's, alive: never the later graph's scratch
            held = {t.untyped_storage().data_ptr() for ts in order[:later] for t in ts}
            for tensors in order[later:]:
                for t in tensors:
                    if t.untyped_storage().data_ptr() not in held:
                        _poison(t)

    return types.SimpleNamespace(replay=replay), out


def on_card(use_jit, *trees):
    """``eager_reason_for`` with every tensor taken as on the card."""
    return eager_reason(use_jit, True)


def emulate(mp):
    """Calls on CPU tensors taken as on the card, the capture emulated
    (``mp``: a ``pytest.MonkeyPatch``)."""
    fake_cuda(mp)
    mp.setattr(FrameGraphs, "_graph", emulated_graph)
    mp.setattr(graphs, "_if_node", emulated_if_node)
    mp.setattr(graphs, "_static_like", _static_outside_pool)
    _OUTSIDE_POOL.clear()  # an earlier test's storages may be reused
    for module in (icpslam_module, map_sharded_module):
        mp.setattr(module, "eager_reason_for", on_card)


def count_at_dispatchers(mp):
    """Both kernels' launch counters raised at their dispatchers (the 1-NN
    solvers' and the health gate's ``nn_points_auto``, the two row
    scatters), each call one launch."""
    def knn(real):
        def nn(src, tgt, mask=None):
            knn_cuda.launches += 1
            return real(src, tgt, mask)
        return nn

    def scatter(real):
        def rows(*args):
            scatter_cuda.launches += 1
            return real(*args)
        return rows

    for module in (icputils, health_module):
        mp.setattr(module, "nn_points_auto", knn(module.nn_points_auto))
    for name in ("_scatter_rows", "_scatter_rows_into"):
        mp.setattr(pointclouds_module, name, scatter(getattr(pointclouds_module, name)))
