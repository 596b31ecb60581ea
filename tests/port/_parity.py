"""Shared inputs of the port's parity tests: the same numpy arrays, made from
a seed or read from the committed goldens, go to the JAX package and to the
PyTorch port. Test files import this after ``pytest.importorskip`` of both
frameworks."""

import os

import jax.numpy as jnp
import numpy as np

import gradslam_tpu as G
from gradslam_torch.interop import pointclouds_from_numpy, rgbdimages_from_numpy

DATA_DIR = os.path.join(os.path.dirname(__file__), "..", "data")
GOLDEN = os.path.join(DATA_DIR, "ref_golden")
MSRD_NAMES = (
    "colors", "depths", "intrinsics", "poses",
    "vertex_map", "normal_map", "global_vertex_map", "global_normal_map",
)


def msrd():
    """The reference test suite's 2 x 3-frame 120x160 clip with its derived
    maps (``tests/data/msrd_b2s3``)."""
    path = os.path.join(DATA_DIR, "msrd_b2s3")
    return {n: np.load(os.path.join(path, f"{n}.npy")) for n in MSRD_NAMES}


def golden(name):
    return np.load(os.path.join(GOLDEN, f"{name}.npy"))


def rigid_transforms(rng, n):
    """``(n, 4, 4)`` float32 rigid transforms from random twists."""
    xi = np.concatenate([rng.randn(n, 3) * 0.5, rng.randn(n, 3) * 0.7], axis=1)
    return np.array(G.se3_exp(jnp.asarray(xi, jnp.float32)))


def both_frames(rgb, depth, K, poses=None, normal_pitch=1):
    """The same clip as a JAX and a torch (CPU) ``RGBDImages``."""
    jf = G.RGBDImages(
        jnp.asarray(rgb), jnp.asarray(depth), jnp.asarray(K),
        None if poses is None else jnp.asarray(poses),
        normal_pitch=normal_pitch,
    )
    tf = rgbdimages_from_numpy(rgb, depth, K, poses, normal_pitch=normal_pitch)
    return jf, tf


def jax_map_to_torch(pc):
    """Carry a JAX map across to the port through numpy."""

    def arr(x):
        return None if x is None else np.asarray(x)

    return pointclouds_from_numpy(
        arr(pc.points), arr(pc.num_points), normals=arr(pc.normals),
        colors=arr(pc.colors), features=arr(pc.features),
        num_dropped=arr(pc.num_dropped),
    )
