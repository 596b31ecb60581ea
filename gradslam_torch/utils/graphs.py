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

The kernels' launch counters (``ops.knn_cuda.launches``,
``ops.scatter_cuda.launches``) are Python integers that a wrapper raises when
it runs. A replay runs no wrapper, so each graph records the launches its
capture made (and the capture's own increments are taken back: a capture
launches nothing), and every replay adds them: the counters read the same
whether a run was captured or not.

:func:`eager_reason` decides which calls are captured: ``use_jit``, inputs
on the card, no input that needs a gradient (grad mode on), recovery
unarmed. It is a pure function of those facts, so it is tested without a
card.
"""

from __future__ import annotations

import dataclasses
import time
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
]

# the modules whose ``launches`` count their kernel's launches
LAUNCH_COUNTERS = (knn_cuda, scatter_cuda)

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


def eager_reason(use_jit: bool, on_card: bool, needs_grad: bool,
                 armed: bool = False) -> Optional[str]:
    r"""``None`` when a pipeline call is captured and replayed as CUDA
    graphs, else why it runs eagerly: ``use_jit`` off; inputs not on the
    card (a CPU run has nothing to capture); an input that needs a gradient
    under grad mode (autograd records the eager ops; ``remat`` too); armed
    recovery (its read backs split the frame)."""
    if not use_jit:
        return "use_jit=False"
    if not on_card:
        return "inputs not on the card"
    if needs_grad:
        return "an input needs a gradient"
    if armed:
        return "recovery armed (relocalize_below > 0)"
    return None


def eager_reason_for(use_jit: bool, *trees, armed: bool = False) -> Optional[str]:
    """:func:`eager_reason` read from the tensors of ``trees``."""
    leaves = [t for tree in trees for t in flatten(tree)[0]]
    return eager_reason(
        use_jit,
        on_card=bool(leaves) and all(t.is_cuda for t in leaves),
        needs_grad=torch.is_grad_enabled() and any(t.requires_grad for t in leaves),
        armed=armed,
    )


def cache_key(name: str, options: tuple, leaves: List[torch.Tensor], spec: tuple) -> tuple:
    """The key of a call of path ``name`` with ``options`` on the inputs
    ``flatten`` gave as ``leaves`` and ``spec``."""
    return (name, options, spec, tuple((tuple(t.shape), t.dtype, t.device) for t in leaves))


def _read_counters() -> Tuple[int, ...]:
    return tuple(m.launches for m in LAUNCH_COUNTERS)


class CapturedCall:
    r"""One captured frame body: the graph, its static inputs and outputs,
    the output structure, and the launches of each counter its capture
    recorded."""

    def __init__(self, graph, static_in: List[torch.Tensor],
                 static_out: List[torch.Tensor], out_spec: tuple,
                 launches: Tuple[int, ...]):
        self.graph = graph
        self.static_in = static_in
        self.static_out = static_out
        self.out_spec = out_spec
        self.launches = launches

    def __call__(self, leaves: List[torch.Tensor]):
        for dst, src in zip(self.static_in, leaves):
            dst.copy_(src)
        self.graph.replay()
        for counter, n in zip(LAUNCH_COUNTERS, self.launches):
            counter.launches += n
        return unflatten(self.out_spec, self.static_out)


class FrameGraphs:
    r"""A pipeline's CUDA graphs, one for each key, sharing one memory pool
    and one capture stream; :meth:`clear` frees them and the pool.

    ``capture_s`` sums the seconds spent capturing (the warm-ups excluded);
    ``len()`` is the number of graphs."""

    def __init__(self):
        self._entries: Dict[tuple, CapturedCall] = {}
        self._pool = None
        self._stream = None
        self.capture_s = 0.0

    def __len__(self) -> int:
        return len(self._entries)

    def clear(self) -> None:
        self._entries.clear()
        self._pool = self._stream = None
        self.capture_s = 0.0

    def __call__(self, name: str, fn: Callable, args: tuple, options: tuple = ()):
        r"""``fn(*args)``, from the graph of this call's key: replayed when
        the key has one, else run eagerly and captured. The result of a
        replay is the graph's static outputs (see the module docstring)."""
        leaves, spec = flatten(args)
        key = cache_key(name, options, leaves, spec)
        entry = self._entries.get(key)
        if entry is not None:
            return entry(leaves)
        return self._capture(key, fn, leaves, spec)

    def _capture(self, key: tuple, fn: Callable, leaves: List[torch.Tensor], spec: tuple):
        device = leaves[0].device
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
            self._pool = torch.cuda.graph_pool_handle()
        stream = self._stream
        # the static inputs, outside the pool: the next call copies into them
        static_in = [torch.empty(t.shape, dtype=t.dtype, device=t.device) for t in leaves]
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            for dst, src in zip(static_in, leaves):
                dst.copy_(src)
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:  # the warm-up: this call's result
                result = fn(*unflatten(spec, static_in))
            finally:
                torch.cuda.set_sync_debug_mode(mode)
        t0 = time.perf_counter()
        before = _read_counters()
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, pool=self._pool, stream=stream):
                out = fn(*unflatten(spec, static_in))
        except RuntimeError as err:
            raise RuntimeError(
                f"CUDA graph capture of the {key[0]!r} frame body (options {key[1]}) failed: "
                f"{err}") from err
        finally:
            captured = tuple(a - b for a, b in zip(_read_counters(), before))
            for counter, n in zip(LAUNCH_COUNTERS, before):
                counter.launches = n
        torch.cuda.current_stream(device).wait_stream(stream)
        static_out, out_spec = flatten(out)
        self._entries[key] = CapturedCall(graph, static_in, static_out, out_spec, captured)
        self.capture_s += time.perf_counter() - t0
        return result
