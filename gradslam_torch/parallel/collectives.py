r"""The collectives of the parallel package, each behind one helper that
counts what it moves.

Every cross-process exchange of :mod:`~gradslam_torch.parallel.sharding`
and :mod:`~gradslam_torch.parallel.map_sharded` goes through
:func:`all_gather`, :func:`all_reduce` or :func:`gather_batch`, on a
``torch.distributed`` process group: NCCL on the card, gloo on the CPU.
Each call adds its bytes to ``BYTES[tag]`` and one to ``CALLS[tag]``: the
gathered output's size for a gather (``K`` times the input), the tensor's
size for a reduction. A tag names the traffic (``'fusion'``, ``'window'``,
``'normal_eq'``, ...), so a caller can hold one kind of traffic to its
budget. :func:`reset_counts` zeroes both counters.

Both are tallies of the CUDA-graph layer
(:func:`~gradslam_torch.utils.graphs.register_tally`): a collective issued
inside a captured frame body is counted once by its capture, which takes
the count back, and then on every replay of the graph, so a captured run
reads the bytes and calls of an eager one.
"""

from __future__ import annotations

import collections

import torch
import torch.distributed as dist

from ..utils import graphs

__all__ = ["BYTES", "CALLS", "all_gather", "all_reduce", "gather_batch", "reset_counts"]

BYTES: "collections.Counter[str]" = collections.Counter()
CALLS: "collections.Counter[str]" = collections.Counter()
graphs.register_tally("collectives.BYTES", BYTES)
graphs.register_tally("collectives.CALLS", CALLS)


def reset_counts() -> None:
    BYTES.clear()
    CALLS.clear()


def _count(tag: str, tensor: torch.Tensor) -> None:
    BYTES[tag] += tensor.numel() * tensor.element_size()
    CALLS[tag] += 1


def all_gather(x: torch.Tensor, group, tag: str) -> torch.Tensor:
    """``(K, *x.shape)``: every rank's ``x`` in group-rank order."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    out = torch.stack(parts)
    _count(tag, out)
    return out


def all_reduce(x: torch.Tensor, group, tag: str, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """The elementwise reduction (``op``, a sum by default) of every rank's
    ``x``; ``x`` is not written."""
    out = x.contiguous().clone()
    dist.all_reduce(out, op=op, group=group)
    _count(tag, out)
    return out


class _ShareGrad(torch.autograd.Function):
    """Identity whose backward scales the gradient by ``scale``."""

    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad * ctx.scale, None


def gather_batch(x: torch.Tensor, group, tag: str) -> torch.Tensor:
    r"""Every rank's ``x`` concatenated along dim 0, in group-rank order.

    Differentiable where ``x`` needs a gradient, through
    ``torch.distributed.nn.functional.all_gather``, whose backward sums the
    ranks' gradients of the gathered output. Every rank computes the same
    loss from the whole gathered batch, so each rank's share of that sum
    is divided by the number of ranks: each rank's block gets the
    gradient a single process would give it."""
    if not (x.requires_grad and torch.is_grad_enabled()):
        out = all_gather(x, group, tag)
        return out.reshape((-1,) + tuple(x.shape[1:]))
    from torch.distributed.nn.functional import all_gather as all_gather_autograd

    k = dist.get_world_size(group)
    parts = all_gather_autograd(_ShareGrad.apply(x.contiguous(), 1.0 / k), group=group)
    out = torch.cat(parts, dim=0)
    _count(tag, out)
    return out
