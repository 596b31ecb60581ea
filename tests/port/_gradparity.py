"""Shared pieces of the port's gradient tests: one small clip with invalid
pixels, made from a seed with numpy, differentiated by ``jax.grad`` through
the JAX package and by ``torch.autograd`` through the port, with respect to
the depth images and the intrinsics. Test files import this after
``pytest.importorskip`` of both frameworks."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import gradslam_tpu as G
import gradslam_torch as T

B, L, H, W = 2, 3, 24, 32


def clip(seed=0, invalid=0.05):
    """``synthetic_sequence(B, L, H, W, seed)`` with a share ``invalid`` of
    the depth pixels set to 0; returns ``(rgb, depth, K, poses, zeroed)``."""
    rgb, depth, K, P = T.synthetic_sequence(B, L, H, W, seed=seed)
    zeroed = np.random.RandomState(seed + 1).rand(*depth.shape) < invalid
    depth = np.where(zeroed, 0.0, depth).astype(np.float32)
    return rgb, depth, K, P, zeroed


def loss_of(pc, poses, with_poses):
    """``sum(points^2)`` of the map, plus ``sum(t^2)`` of the poses'
    translations for tracked runs (works for both frameworks)."""
    out = (pc.points ** 2).sum()
    if with_poses:
        out = out + (poses[..., :3, 3] ** 2).sum()
    return out


def jax_grads(cls, kw, data, with_poses):
    """``jax.grad`` of :func:`loss_of` through ``getattr(G, cls)(**kw)``
    (jitted as a whole, as ``scripts/bench_all.py`` does): ``(g_depth,
    g_K)`` as numpy arrays."""
    rgb, depth, K, P = (jnp.asarray(a) for a in data[:4])
    slam = getattr(G, cls)(use_jit=False, **kw)

    def loss(d, k):
        pc, poses = slam(G.RGBDImages(rgb, d, k, P))
        return loss_of(pc, poses, with_poses)

    gd, gk = jax.jit(jax.grad(loss, argnums=(0, 1)))(depth, K)
    return np.asarray(gd), np.asarray(gk)


def torch_run(cls, kw, data, with_poses, remat=False, device="cpu"):
    """The port's forward and backward of :func:`loss_of` through
    ``getattr(T, cls)(**kw)``: ``(pointclouds, poses, g_depth, g_K)``."""
    rgb, depth, K, P = (torch.from_numpy(np.asarray(a, np.float32)).to(device)
                        for a in data[:4])
    depth.requires_grad_()
    K.requires_grad_()
    slam = getattr(T, cls)(remat=remat, **kw)
    pc, poses = slam(T.RGBDImages(rgb, depth, K, P))
    loss_of(pc, poses, with_poses).backward()
    return pc, poses, depth.grad, K.grad


def max_gap(got, want) -> float:
    return float(np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)).max())


def same_forward(a, b) -> bool:
    """The two runs' maps and poses hold the same bits."""
    (pa, qa), (pb, qb) = a, b
    bufs = ("points", "normals", "colors", "features", "num_points", "num_dropped")
    return torch.equal(qa, qb) and all(
        (getattr(pa, n) is None and getattr(pb, n) is None)
        or torch.equal(getattr(pa, n), getattr(pb, n)) for n in bufs)


def vjp_torch(fn, args, w):
    """Gradients of ``sum(fn(*args) * w)`` to each of the numpy ``args``,
    by ``torch.autograd``."""
    args = [torch.tensor(a, requires_grad=True) for a in args]
    (fn(*args) * torch.tensor(w)).sum().backward()
    return [a.grad.numpy() for a in args]


def vjp_jax(fn, args, w):
    """The same by ``jax.grad``."""
    return [np.asarray(g) for g in jax.grad(
        lambda *a: jnp.sum(fn(*a) * jnp.asarray(w)), argnums=tuple(range(len(args))))(
        *[jnp.asarray(a) for a in args])]
