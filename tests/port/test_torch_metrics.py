"""The port's trajectory metrics held against the JAX package on the CPU.

Tolerance: ATE and the alignment within 1e-6 on random trajectories (the
3x3 SVD is float32 on both sides)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from gradslam_torch.metrics import align_trajectories, ate_rmse  # noqa: E402
from gradslam_tpu import metrics as JM  # noqa: E402

from ._parity import rigid_transforms  # noqa: E402


def _trajectories(seed, L=30):
    """A ground-truth trajectory and an estimate that is a rigidly moved,
    noisy copy of it."""
    rng = np.random.RandomState(seed)
    gt = rigid_transforms(rng, L)
    gt[:, :3, 3] = np.cumsum(0.05 * rng.randn(L, 3), axis=0)
    move = rigid_transforms(rng, 1)[0]
    est = (move @ gt).astype(np.float32)
    est[:, :3, 3] += (0.01 * rng.randn(L, 3)).astype(np.float32)
    return est, gt


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("align", [True, False])
def test_ate_rmse_matches_jax(seed, align):
    est, gt = _trajectories(seed)
    ours = float(ate_rmse(torch.from_numpy(est), torch.from_numpy(gt), align=align))
    theirs = float(JM.ate_rmse(jnp.asarray(est), jnp.asarray(gt), align=align))
    assert abs(ours - theirs) <= 1e-6
    if align:  # the rigid motion is taken out; the 1 cm noise remains
        assert 0.005 < ours < 0.03


@pytest.mark.parametrize("with_scale", [False, True])
def test_align_trajectories_matches_jax(with_scale):
    est, gt = _trajectories(3)
    R, t, s = align_trajectories(torch.from_numpy(est[:, :3, 3]), torch.from_numpy(gt),
                                 with_scale=with_scale)
    jR, jt, js = JM.align_trajectories(jnp.asarray(est[:, :3, 3]), jnp.asarray(gt),
                                       with_scale=with_scale)
    np.testing.assert_allclose(R.numpy(), np.asarray(jR), atol=1e-6, rtol=0)
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), atol=1e-6, rtol=0)
    assert abs(float(s) - float(js)) <= 1e-6
    with pytest.raises(ValueError):
        ate_rmse(torch.zeros(3, 3, 3), torch.zeros(3, 3, 3))
