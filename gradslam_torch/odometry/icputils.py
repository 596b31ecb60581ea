r"""Point-to-plane ICP solver toolbox, LM and gradLM (PyTorch).

Counterpart of ``gradslam_tpu/odometry/icputils.py``: ``solve_linear_system``
(:53), ``robust_weights`` (:76), ``_normal_gate`` (:105), ``validate_robust``
(:125), ``validate_pyramid`` (:141), ``gauss_newton_solve`` (:170),
``_ptp_system`` (:212), ``_safe_sqrt`` (:229), ``_guard_robust_step`` (:238),
``_reused_residual`` (:301), ``point_to_plane_ICP`` (:370),
``point_to_plane_gradICP`` (:460), ``downsample_pointclouds`` (:556) and
``downsample_rgbdimages`` (:590).

The JAX solvers work on one cloud pair and are ``vmap``-ed; here every
function takes an explicit leading batch dimension, and the ``lax.scan``
over solver iterations is a Python loop. Invalid rows of the linear system
are zeroed, so they add nothing to the normal equations, and the damped 6x6
systems are solved with ``torch.linalg.solve_ex(check_errors=False)``, which
does not read an error flag back to the host.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..geometry.geometryutils import transform_pointcloud
from ..geometry.se3utils import se3_exp
from ..ops import nn_points_auto
from ..structures.pointclouds import Pointclouds, compact_masked, gather_rows
from ..structures.rgbdimages import RGBDImages

__all__ = [
    "solve_linear_system",
    "robust_weights",
    "validate_robust",
    "validate_pyramid",
    "gauss_newton_solve",
    "point_to_plane_ICP",
    "point_to_plane_gradICP",
    "downsample_pointclouds",
    "downsample_rgbdimages",
]


def solve_linear_system(A: torch.Tensor, b: torch.Tensor, damp=1e-8) -> torch.Tensor:
    r"""Solve ``(A^T A + damp I) x = A^T b`` for ``A (B, N, 6)``,
    ``b (B, N, 1)`` and ``damp`` a float or ``(B,)`` tensor. Returns
    ``(B, 6, 1)``. Invalid rows must be zeroed by the caller."""
    if A.ndim != 3 or b.ndim != 3 or b.shape[-1] != 1 or A.shape[:2] != b.shape[:2]:
        raise ValueError(
            f"A and b must be (B, N, K) and (B, N, 1). Got {tuple(A.shape)} and {tuple(b.shape)}."
        )
    damp = torch.as_tensor(damp, dtype=A.dtype, device=A.device).reshape(-1, 1, 1)
    At = A.transpose(1, 2)
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    AtA = torch.matmul(At, A) + damp * eye
    x, _info = torch.linalg.solve_ex(AtA, torch.matmul(At, b), check_errors=False)
    return x


def robust_weights(r: torch.Tensor, loss: Optional[str], scale: float) -> torch.Tensor:
    r"""IRLS square-root weights of a robust loss at residuals ``r``:
    ``None`` gives ones (plain least squares), ``'huber'``
    ``min(1, sqrt(scale / |r|))`` and ``'tukey'`` ``1 - (r / scale)^2``
    inside ``|r| <= scale``, 0 outside."""
    if loss is None:
        return torch.ones_like(r)
    if loss == "huber":
        return torch.clamp(torch.sqrt(scale / torch.clamp(torch.abs(r), min=1e-12)), max=1.0)
    if loss == "tukey":
        u = torch.clamp(r / scale, -1.0, 1.0)
        return 1.0 - u * u
    raise ValueError(f"Unknown robust loss: {loss!r}. Expected None, 'huber' or 'tukey'.")


def _normal_gate(src_n: torch.Tensor, assoc_n: torch.Tensor, dot_gate: float) -> torch.Tensor:
    r"""Cosine gate ``n1 . n2 >= gate * |n1| |n2|``: the normalized test
    without a division, since fused map normals are averages and not unit
    vectors. ``>=`` so that ``dot_gate=-1`` admits every row."""
    dot = torch.sum(src_n * assoc_n, dim=-1)
    nn = torch.linalg.norm(src_n, dim=-1) * torch.linalg.norm(assoc_n, dim=-1)
    return dot >= dot_gate * torch.clamp(nn, min=1e-12)


def validate_robust(robust_loss, robust_scale) -> None:
    """Constructor-time check of the robust kernel's parameters."""
    if robust_loss not in (None, "huber", "tukey"):
        raise ValueError(
            f"Unknown robust_loss: {robust_loss!r}. Expected None, 'huber' or 'tukey'."
        )
    if robust_loss is not None and not robust_scale > 0:
        # scale 0 zeroes every weight and silently turns the solver off
        raise ValueError(f"robust_scale must be > 0. Got {robust_scale}.")


def validate_pyramid(pyramid):
    """Normalize a coarse-to-fine ``[(dsratio, numiters), ...]`` schedule
    (or None)."""
    if pyramid is None:
        return None
    try:
        pyramid = [(int(d), int(n)) for d, n in pyramid]
    except (TypeError, ValueError) as e:
        raise ValueError(
            f"pyramid must be a list of (dsratio, numiters) pairs. Got {pyramid!r}."
        ) from e
    if not pyramid or any(d < 1 or n < 1 for d, n in pyramid):
        raise ValueError(
            f"pyramid levels must have dsratio >= 1 and numiters >= 1. Got {pyramid!r}."
        )
    ds = [d for d, _ in pyramid]
    if any(d2 > d1 for d1, d2 in zip(ds, ds[1:])):
        raise ValueError(
            f"pyramid must be coarse-to-fine (non-increasing dsratio). Got dsratios {ds}."
        )
    return pyramid


def _validate_gate_args(dot_gate, src_normals) -> None:
    if dot_gate is not None and src_normals is None:
        raise ValueError("dot_gate requires src_normals.")
    if src_normals is not None and dot_gate is None:
        raise ValueError(
            "src_normals were provided but dot_gate is None: the gate is their "
            "only consumer. Pass dot_gate (-1.0 admits everything) or drop them."
        )


def _ptp_system(s, assoc_pts, assoc_normals, valid, robust_loss=None, robust_scale=0.05):
    """Masked, optionally IRLS-weighted point-to-plane rows
    ``A = [n | s x n]``, ``b = n . (d - s)``."""
    n = assoc_normals
    A = torch.cat([n, torch.linalg.cross(s, n, dim=-1)], dim=-1)
    b = torch.sum(n * (assoc_pts - s), dim=-1, keepdim=True)
    validf = valid[..., None].to(A.dtype)
    if robust_loss is not None:
        validf = validf * robust_weights(b, robust_loss, robust_scale)
    return A * validf, b * validf


def gauss_newton_solve(
    src_pc: torch.Tensor,  # (B, N, 3)
    tgt_pc: torch.Tensor,  # (B, M, 3)
    tgt_normals: torch.Tensor,  # (B, M, 3)
    src_mask: Optional[torch.Tensor] = None,  # (B, N) bool
    tgt_mask: Optional[torch.Tensor] = None,  # (B, M) bool
    dist_thresh: Optional[float] = None,
    robust_loss: Optional[str] = None,
    robust_scale: float = 0.05,
    src_normals: Optional[torch.Tensor] = None,  # (B, N, 3), same frame as tgt
    dot_gate: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    r"""Linearise the point-to-plane error around the current source cloud.
    Returns ``(A (B, N, 6), b (B, N, 1), chamfer_idx (B, N))``; rows of
    masked-out, distance-filtered (``dist_thresh`` in squared metres) or
    normal-gated source points are zero, and ``robust_loss`` weights the
    rest."""
    _validate_gate_args(dot_gate, src_normals)
    dists, idx = nn_points_auto(src_pc, tgt_pc, tgt_mask)
    valid = (
        torch.ones(src_pc.shape[:2], dtype=torch.bool, device=src_pc.device)
        if src_mask is None else src_mask
    )
    if dist_thresh is not None:
        valid = valid & (dists < dist_thresh)
    assoc_normals = gather_rows(tgt_normals, idx)
    if dot_gate is not None:
        valid = valid & _normal_gate(src_normals, assoc_normals, dot_gate)
    A, b = _ptp_system(
        src_pc, gather_rows(tgt_pc, idx), assoc_normals, valid, robust_loss, robust_scale
    )
    return A, b, idx


_MIN_INLIER_MASS = 12.0  # two constraints per DOF of the 6-vector solve
_TRUST_RADIUS_SCALES = 10.0  # max point motion per iteration, in robust_scale units


def _safe_sqrt(sq: torch.Tensor) -> torch.Tensor:
    """sqrt whose gradient is 0, not inf, at 0 (double where)."""
    pos = sq > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, sq, torch.ones_like(sq))),
                       torch.zeros_like(sq))


def _guard_robust_step(xi, A, robust_scale, src_pc, src_mask, wmass=None):
    r"""Bound and fade the solved twists ``xi (B, 6)`` of robust solves
    (``gradslam_tpu/odometry/icputils.py:238``). Both factors are exactly 1
    for healthy solves.

    - Trust region: the worst-case point motion of the step, taken about the
      cloud's centroid ``c`` (``|v + w x c| + |w| r_spread``), is capped at
      ``10 * robust_scale``.
    - Inlier-mass fade: below ``min(12, N / 2)`` units of squared-weight
      mass ``sum(A[:, :3]^2)`` (or ``wmass``) the step fades linearly to 0.
      ``N`` is the PADDED row count ``src_pc.shape[1]``, as in the JAX
      package; the valid count would change trajectories.

    Both bounds are ``torch.minimum``/``torch.maximum``, not ``clamp``: at
    a tie they split the gradient between the two sides, as JAX's
    ``jnp.minimum``/``jnp.maximum`` do, where ``clamp`` passes all of it.
    The bounds are 0-d CPU tensors, which a CUDA op takes as scalars.
    """
    mass_floor = min(_MIN_INLIER_MASS, 0.5 * src_pc.shape[1])
    if wmass is None:
        wmass = torch.sum(A[..., :3] ** 2, dim=(1, 2))
    fade = torch.minimum(wmass / mass_floor, torch.ones((), dtype=wmass.dtype))
    radius = _TRUST_RADIUS_SCALES * robust_scale
    v, omega = xi[:, :3], xi[:, 3:]
    if src_mask is None:
        c = torch.mean(src_pc, dim=1)
        r2 = torch.amax(torch.sum((src_pc - c[:, None]) ** 2, dim=-1), dim=1)
    else:
        m = src_mask.to(src_pc.dtype)[..., None]
        cnt = torch.clamp(torch.sum(m, dim=(1, 2)), min=1.0)
        c = torch.sum(src_pc * m, dim=1) / cnt[:, None]
        r2 = torch.amax(torch.sum(((src_pc - c[:, None]) * m) ** 2, dim=-1), dim=1)
    disp = (_safe_sqrt(torch.sum((v + torch.linalg.cross(omega, c, dim=-1)) ** 2, dim=-1))
            + _safe_sqrt(torch.sum(omega * omega, dim=-1)) * _safe_sqrt(r2))
    trust = radius / torch.maximum(disp, torch.full((), radius, dtype=disp.dtype))
    return xi * (fade * trust)[:, None]


def _reused_residual(pc, idx, tgt_pc, tgt_normals, src_mask, dist_thresh,
                     robust_loss=None, robust_scale=0.05, src_normals=None, dot_gate=None):
    """Lookahead residual ``b (B, N, 1)`` with the iteration's association
    ``idx`` kept: only distances and residuals at the moved source points are
    recomputed (no second 1-NN search). ``src_normals`` must be rotated to
    the moved source when ``dot_gate`` is set."""
    assoc_pts = gather_rows(tgt_pc, idx)
    assoc_normals = gather_rows(tgt_normals, idx)
    valid = (
        torch.ones(pc.shape[:2], dtype=torch.bool, device=pc.device)
        if src_mask is None else src_mask
    )
    if dist_thresh is not None:
        valid = valid & (torch.sum((pc - assoc_pts) ** 2, dim=-1) < dist_thresh)
    if dot_gate is not None:
        valid = valid & _normal_gate(src_normals, assoc_normals, dot_gate)
    _, b = _ptp_system(pc, assoc_pts, assoc_normals, valid, robust_loss, robust_scale)
    return b


def _rotate(x: torch.Tensor, transform: torch.Tensor) -> torch.Tensor:
    """``x (B, N, 3) @ R^T``: points or normals rotated by transforms
    ``(B, 4, 4)``."""
    return torch.matmul(x, transform[:, :3, :3].transpose(1, 2))


def _knn_icp_core(
    mode: str,  # 'lm' (classic accept/reject) or 'gradlm'
    src_pc, tgt_pc, tgt_normals, initial_transform, numiters: int, damp: float,
    dist_thresh, lambda_max: float, B: float, B2: float, nu: float,
    src_mask, tgt_mask, lookahead_assoc: str, robust_loss, robust_scale: float,
    src_normals, dot_gate,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 1-NN solvers' shared loop: each iteration associates, solves the
    damped system, guards a robust step and evaluates the lookahead error;
    ``'lm'`` then accepts or rejects the step and halves or doubles the
    damping, ``'gradlm'`` blends both smoothly. Takes ``(N, 3)`` clouds as a
    batch of one or ``(B, N, 3)`` clouds, and returns ``(transform,
    chamfer_idx)`` of the last iteration in the same form."""
    if lookahead_assoc not in ("fresh", "reuse"):
        raise ValueError(f"Unknown lookahead_assoc mode: {lookahead_assoc}")
    if numiters < 1:
        raise ValueError(f"numiters must be >= 1. Got {numiters}.")
    _validate_gate_args(dot_gate, src_normals)
    batched = src_pc.ndim == 3
    if not batched:
        src_pc, tgt_pc, tgt_normals = src_pc[None], tgt_pc[None], tgt_normals[None]
        src_mask = None if src_mask is None else src_mask[None]
        tgt_mask = None if tgt_mask is None else tgt_mask[None]
        src_normals = None if src_normals is None else src_normals[None]
        if initial_transform is not None:
            initial_transform = initial_transform[None]
    nb = src_pc.shape[0]
    if initial_transform is None:
        initial_transform = torch.eye(
            4, dtype=src_pc.dtype, device=src_pc.device
        ).expand(nb, 4, 4)
    transform = initial_transform
    pc = transform_pointcloud(src_pc, transform)
    damp_t = torch.full((nb,), damp, dtype=src_pc.dtype, device=src_pc.device)
    lambda_min = 1.0 / lambda_max
    src_n = None if dot_gate is None else src_normals.to(src_pc.dtype)

    def gn(p, nrm):
        return gauss_newton_solve(p, tgt_pc, tgt_normals, src_mask, tgt_mask, dist_thresh,
                                  robust_loss, robust_scale, nrm, dot_gate)

    idx = None
    for _ in range(numiters):
        n_cur = None if src_n is None else _rotate(src_n, transform)
        A, b, idx = gn(pc, n_cur)
        xi = solve_linear_system(A, b, damp_t)[..., 0]  # (B, 6)
        if robust_loss is not None:
            xi = _guard_robust_step(xi, A, robust_scale, pc, src_mask)
        residual_transform = se3_exp(xi)
        err = torch.sum(b * b, dim=(1, 2))
        one_step_pc = transform_pointcloud(pc, residual_transform)
        n_step = None if n_cur is None else _rotate(n_cur, residual_transform)
        if lookahead_assoc == "reuse":
            b1 = _reused_residual(one_step_pc, idx, tgt_pc, tgt_normals, src_mask, dist_thresh,
                                  robust_loss, robust_scale, n_step, dot_gate)
        else:
            _, b1, _ = gn(one_step_pc, n_step)
        new_err = torch.sum(b1 * b1, dim=(1, 2))

        if mode == "lm":
            accept = new_err < err
            pc = torch.where(accept[:, None, None], one_step_pc, pc)
            transform = torch.where(accept[:, None, None],
                                    torch.matmul(residual_transform, transform), transform)
            damp_t = torch.where(accept, damp_t / 2.0, damp_t * 2.0)
        else:
            errdiff = torch.clamp(new_err - err, -70.0, 70.0)
            damp_new = lambda_min + (lambda_max - lambda_min) / (1.0 + torch.exp(-B * errdiff))
            damp_t = damp_t * damp_new
            sigmoid = 1.0 / (1.0 + torch.exp(-B2 * errdiff)) ** (1.0 / nu)
            scaled_transform = se3_exp(sigmoid[:, None] * xi)
            pc = transform_pointcloud(pc, scaled_transform)
            transform = torch.matmul(scaled_transform, transform)
    if not batched:
        return transform[0], idx[0]
    return transform, idx


def point_to_plane_ICP(
    src_pc: torch.Tensor,
    tgt_pc: torch.Tensor,
    tgt_normals: torch.Tensor,
    initial_transform: Optional[torch.Tensor] = None,
    numiters: int = 20,
    damp: float = 1e-8,
    dist_thresh: Optional[float] = None,
    src_mask: Optional[torch.Tensor] = None,
    tgt_mask: Optional[torch.Tensor] = None,
    lookahead_assoc: str = "fresh",
    robust_loss: Optional[str] = None,
    robust_scale: float = 0.05,
    src_normals: Optional[torch.Tensor] = None,
    dot_gate: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    r"""Point-to-plane ICP with the classic LM accept/reject loop
    (``gradslam_tpu/odometry/icputils.py:370``): a step is taken only when
    the lookahead error is smaller, and the damping then halves (else
    doubles). ``lookahead_assoc``, ``robust_loss``/``robust_scale`` and
    ``dot_gate``/``src_normals`` as in :func:`point_to_plane_gradICP`.

    Clouds are ``(N, 3)`` or batched ``(B, N, 3)``; masks ``(N,)``/``(B, N)``.
    Returns ``(transform, chamfer_idx)``: ``(4, 4)`` and ``(N,)`` for
    unbatched input, ``(B, 4, 4)`` and ``(B, N)`` for batched input.
    """
    return _knn_icp_core(
        "lm", src_pc, tgt_pc, tgt_normals, initial_transform, numiters, damp, dist_thresh,
        2.0, 1.0, 1.0, 200.0, src_mask, tgt_mask, lookahead_assoc, robust_loss, robust_scale,
        src_normals, dot_gate,
    )


def point_to_plane_gradICP(
    src_pc: torch.Tensor,
    tgt_pc: torch.Tensor,
    tgt_normals: torch.Tensor,
    initial_transform: Optional[torch.Tensor] = None,
    numiters: int = 20,
    damp: float = 1e-8,
    dist_thresh: Optional[float] = None,
    lambda_max: float = 2.0,
    B: float = 1.0,
    B2: float = 1.0,
    nu: float = 200.0,
    src_mask: Optional[torch.Tensor] = None,
    tgt_mask: Optional[torch.Tensor] = None,
    lookahead_assoc: str = "fresh",
    robust_loss: Optional[str] = None,
    robust_scale: float = 0.05,
    src_normals: Optional[torch.Tensor] = None,
    dot_gate: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    r"""Differentiable gradLM ICP (reference icputils.py:370-545): smooth
    sigmoid-blended damping and step scaling, the step always applied, the
    error difference clamped to +-70.

    ``lookahead_assoc``: ``'fresh'`` re-associates for the lookahead error
    (a second nearest-neighbour search per iteration), ``'reuse'`` keeps the
    iteration's association. ``robust_loss``/``robust_scale`` weight the rows
    and guard the step (:func:`_guard_robust_step`). ``dot_gate`` with
    ``src_normals`` (in the source cloud's frame; they rotate with every
    iterate) rejects normal-incompatible associations.

    Clouds are ``(N, 3)`` or batched ``(B, N, 3)``; masks ``(N,)``/``(B, N)``.
    Returns ``(transform, chamfer_idx)``: ``(4, 4)`` and ``(N,)`` for
    unbatched input, ``(B, 4, 4)`` and ``(B, N)`` for batched input.
    """
    return _knn_icp_core(
        "gradlm", src_pc, tgt_pc, tgt_normals, initial_transform, numiters, damp, dist_thresh,
        lambda_max, B, B2, nu, src_mask, tgt_mask, lookahead_assoc, robust_loss, robust_scale,
        src_normals, dot_gate,
    )


def downsample_pointclouds(
    pointclouds: Pointclouds,
    active_mask: torch.Tensor,  # (B, CAP) bool
    pix_h: torch.Tensor,  # (B, CAP) int
    pix_w: torch.Tensor,  # (B, CAP) int
    ds_ratio: int,
    capacity: int,
) -> Pointclouds:
    r"""Active map points whose projected pixel is ``0 mod ds`` in both axes,
    compacted into a fixed ``capacity`` buffer. Overflow past ``capacity`` is
    recorded in the returned cloud's ``num_dropped``."""
    if not isinstance(ds_ratio, int):
        raise TypeError(f"Expected ds_ratio to be of type int. Got {type(ds_ratio)}.")
    keep = active_mask & (pix_h % ds_ratio == 0) & (pix_w % ds_ratio == 0)
    points, counts = compact_masked(pointclouds.points, keep, capacity)

    def compact(buf):
        return None if buf is None else compact_masked(buf, keep, capacity)[0]

    return Pointclouds(
        points=points,
        num_points=counts,
        normals=compact(pointclouds.normals),
        colors=compact(pointclouds.colors),
        num_dropped=keep.sum(dim=-1) - counts,
    )


def downsample_rgbdimages(rgbdimages: RGBDImages, ds_ratio: int) -> Pointclouds:
    r"""Strided subsample of a sequence-length-1 frame into a
    :class:`Pointclouds`, invalid-depth points compacted out."""
    if not isinstance(rgbdimages, RGBDImages):
        raise TypeError(
            f"Expected rgbdimages to be of type RGBDImages. Got {type(rgbdimages)}."
        )
    if not isinstance(ds_ratio, int):
        raise TypeError(f"Expected ds_ratio to be of type int. Got {type(ds_ratio)}.")
    if rgbdimages.shape[1] != 1:
        raise ValueError(
            f"Sequence length of rgbdimages must be 1, but was {rgbdimages.shape[1]}."
        )
    B = len(rgbdimages)
    mask = rgbdimages.valid_depth_mask[:, 0, ::ds_ratio, ::ds_ratio, 0].reshape(B, -1)
    N = mask.shape[1]

    def flat(x):
        return x[:, 0, ::ds_ratio, ::ds_ratio].reshape(B, N, 3)

    points, counts = compact_masked(flat(rgbdimages.global_vertex_map), mask, N)
    normals, _ = compact_masked(flat(rgbdimages.global_normal_map), mask, N)
    colors, _ = compact_masked(flat(rgbdimages.rgb_image), mask, N)
    return Pointclouds(points=points, num_points=counts, normals=normals, colors=colors)
