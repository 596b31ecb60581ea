"""Write the JAX package's CPU gradients through its armed forward, the
golden that ``tests/port/test_torch_graphs_armed_grad.py`` holds the port's
captured armed gradient steps against.

For each row of that test (``grad_row``: the 60x80 kidnap cut after frame 8
with the 1-NN tracker, and the short anchored clip), on the test's own
numpy inputs and options, with ``remat=True``:

- a jitted no-grad ``forward``: its poses (``<row>_poses``), the health
  gate's reading of each tracked frame (``<row>_readings``, through a
  ``jax.debug.callback`` on ``ICPSLAM._health_gate``) and, with the anchor
  armed, whether its drift gate flagged a sequence (``<row>_drift``);
- ``jax.grad`` of ``sum(points ** 2)`` of the map through the jitted armed
  forward, to the depths and the intrinsics (``<row>_grad_depth``,
  ``<row>_grad_K``), and to the depths scaled by ``1 + s`` for each s of
  the test's ``SCALES`` (one compile): the pixels where JAX's own depth
  gradient moves by more than the test's bar under such a change, a near
  tie that float32 rounding decides (``<row>_tie``, flat indices into the
  depths), and the gradient there at each scale (``<row>_tie_grads``,
  ``(pixels, len(SCALES))``);
- ``<row>_inputs``: the SHA-256 digest of the inputs and options
  (``inputs_digest``), which the test checks before it compares.

Regenerate it from the root of the repo with

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/port/make_armed_grad_golden.py

(about two minutes on the CPU, most of it compiling the two gradients).
With ``--remat-off`` it writes nothing and prints, for each row, how far
``jax.grad`` through the same forward with ``remat=False`` (the JAX
package's default, which the port's remat-off rows are held to this golden
for) lies from the golden's gradients, relative to their largest magnitude
(about a minute).
"""

import sys

import time

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

import gradslam_tpu as G  # noqa: E402
from tests.port import test_torch_graphs_armed as A  # noqa: E402
from tests.port import test_torch_recovery as R  # noqa: E402
from tests.port.test_torch_graphs_armed_grad import (  # noqa: E402
    BAR,
    GOLDEN,
    ROWS,
    SCALES,
    grad_row,
    inputs_digest,
)


def row(name: str) -> dict:
    arrays, kw = grad_row(name)
    with pytest.MonkeyPatch.context() as mp:
        drift = A.jax_drift_frames(mp)
        _, poses, readings = R.jax_run(mp, arrays, kw)
    rgb, depth, K, P = (jnp.asarray(np.asarray(a, np.float32)) for a in arrays)
    slam = G.PointFusion(use_jit=False, remat=True, **kw)

    def loss(d, k):
        pc, _ = slam(G.RGBDImages(rgb, d, k, P))
        return (pc.points ** 2).sum()

    grad = jax.jit(jax.grad(loss, argnums=(0, 1)))
    grads = [tuple(np.asarray(g) for g in grad(depth * np.float32(1 + s), K)) for s in SCALES]
    gd, gk = grads[0]
    scale = np.abs(gd.astype(np.float64)).max()
    tie = np.zeros(gd.shape, bool)
    for other, _ in grads[1:]:
        tie |= np.abs(other.astype(np.float64) - gd) / scale > BAR
    tie = np.flatnonzero(tie)
    return {"inputs": inputs_digest(arrays, kw), "poses": np.asarray(poses),
            "readings": np.asarray(readings), "drift": np.asarray(drift, bool),
            "grad_depth": gd, "grad_K": gk, "tie": tie,
            "tie_grads": np.stack([g.reshape(-1)[tie] for g, _ in grads], axis=1)}


def remat_off_gaps():
    """Print each row's remat-off gradients against the golden's."""
    from tests.port.test_torch_graphs_armed_grad import golden

    for name in ROWS:
        arrays, kw = grad_row(name)
        rgb, depth, K, P = (jnp.asarray(np.asarray(a, np.float32)) for a in arrays)
        slam = G.PointFusion(use_jit=False, remat=False, **kw)

        def loss(d, k):
            pc, _ = slam(G.RGBDImages(rgb, d, k, P))
            return (pc.points ** 2).sum()

        gd, gk = (np.asarray(g, np.float64)
                  for g in jax.jit(jax.grad(loss, argnums=(0, 1)))(depth, K))
        ref = golden(name)
        jd, jk = ref["grad_depth"].astype(np.float64), ref["grad_K"].astype(np.float64)
        print(f"{name}: remat off against the golden, max |dg| / max |g|: depth "
              f"{np.abs(gd - jd).max() / np.abs(jd).max():.3e}, intrinsics "
              f"{np.abs(gk - jk).max() / np.abs(jk).max():.3e}", flush=True)


def main():
    if "--remat-off" in sys.argv[1:]:
        remat_off_gaps()
        return
    out = {}
    for name in ROWS:
        t0 = time.time()
        for key, value in row(name).items():
            out[f"{name}_{key}"] = value
        print(f"{name}: {time.time() - t0:.1f} s, {len(out[f'{name}_tie'])} near-tie pixels",
              flush=True)
    np.savez_compressed(GOLDEN, **out)
    print("wrote", GOLDEN)


if __name__ == "__main__":
    main()
