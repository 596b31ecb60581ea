r"""Projective data association odometry (frame-to-model, no 1-NN search).

Counterpart of ``gradslam_tpu/odometry/projective.py``: ``projective_associate``
(:73, nearest pixel), ``_projective_icp_core`` (:243, the LM and gradLM
modes), ``point_to_plane_ICP_projective`` (:373),
``point_to_plane_gradICP_projective`` (:407) and
``ProjectiveOdometryProvider`` (:444). The map window is projected into the
live camera at the current pose estimate, and each map point reads the
frame's vertex and normal at the pixel it lands on: per solver iteration one
elementwise projection and one row gather of the packed ``(H*W, 8)`` frame
image, instead of a nearest-neighbour search. ``subpixel`` blends the four
pixels around the projection bilinearly (:137-167); ``point_weight`` adds
three point-to-point rows an association, folded analytically into the 6x6
normal equations (``_point_block_normal_eq``, :186).

Every function takes an explicit leading batch dimension (the JAX package
``vmap``-s single-pair functions).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..geometry.geometryutils import inverse_transformation
from ..geometry.se3utils import se3_exp
from ..structures.pointclouds import Pointclouds, gather_rows
from ..structures.rgbdimages import RGBDImages
from .base import OdometryProvider
from .icputils import (
    _guard_robust_step,
    _normal_gate,
    _ptp_system,
    _rotate,
    robust_weights,
    validate_robust,
)

__all__ = [
    "projective_associate",
    "point_to_plane_ICP_projective",
    "point_to_plane_gradICP_projective",
    "ProjectiveOdometryProvider",
]


def projective_associate(
    map_pts: torch.Tensor,  # (B, N, 3) world frame
    map_normals: torch.Tensor,  # (B, N, 3) world frame
    map_mask: torch.Tensor,  # (B, N) bool
    frame_geom: torch.Tensor,  # (B, H*W, 8): vertex(3) | normal(3) | valid | 0, camera frame
    intrinsics: torch.Tensor,  # (B, 4, 4)
    pose: torch.Tensor,  # (B, 4, 4) camera-to-world
    H: int,
    W: int,
    dist_thresh: Optional[float] = None,
    dot_gate: Optional[float] = None,
    subpixel: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    r"""Associate map points with live-frame points by projection: the map
    points go into the camera at ``pose``, are pinhole-projected with the
    fusion stage's bounds and round-half-to-even snap, and read the frame's
    packed row at the landed pixel.

    ``subpixel=True`` reads a validity-weighted bilinear blend of the four
    pixels around the continuous ``(u, v)`` instead: corners with invalid
    depth get weight 0, the association needs at least half the weight
    valid (``wsum > 0.5``), and the blended normal is renormalised with
    ``max(norm, 1e-12)``. At the right and bottom borders the corners
    collapse onto one column or row when ``W`` or ``H`` is 1. Where the
    blend of normals is 0 (every corner's normal zero, as at the frame's
    borders), the gradient through the renormalisation is 0 here and NaN
    in the JAX package (its norm's VJP at 0); the values are the same.

    Returns ``(s, valid, n_frame)``: ``s (B, N, 3)``, the associated frame
    point in world coordinates; ``valid (B, N)``, in the frustum, on valid
    depth, within ``dist_thresh`` (squared metres) and within the normal gate
    (``dot_gate``, a minimum cosine); ``n_frame (B, N, 3)``, the frame normal
    at the landed pixel in world coordinates."""
    tinv = inverse_transformation(pose)
    cam = _rotate(map_pts, tinv) + tinv[:, None, :3, 3]
    x, y, z = cam[..., 0], cam[..., 1], cam[..., 2]
    fx, fy = intrinsics[:, 0, 0][:, None], intrinsics[:, 1, 1][:, None]
    cx, cy = intrinsics[:, 0, 2][:, None], intrinsics[:, 1, 2][:, None]
    zg = torch.where(z == 0, torch.ones_like(z), z)
    u = fx * (x / zg) + cx
    v = fy * (y / zg) + cy
    valid = (
        (u > -1e-3) & (u < W - 0.999) & (v > -1e-3) & (v < H - 0.999) & (z > 0) & map_mask
    )
    if subpixel:
        uc = torch.clamp(u, 0.0, W - 1.0)
        vc = torch.clamp(v, 0.0, H - 1.0)
        u0 = torch.clamp(torch.floor(uc), 0, max(W - 2, 0)).to(torch.int64)
        v0 = torch.clamp(torch.floor(vc), 0, max(H - 2, 0)).to(torch.int64)
        fu = uc - u0.to(uc.dtype)
        fv = vc - v0.to(vc.dtype)
        base = v0 * W + u0
        du = 1 if W > 1 else 0
        dv = W if H > 1 else 0
        corners = (
            (base, (1.0 - fu) * (1.0 - fv)),
            (base + du, fu * (1.0 - fv)),
            (base + dv, (1.0 - fu) * fv),
            (base + du + dv, fu * fv),
        )
        acc = torch.zeros(map_pts.shape[:-1] + (6,), dtype=frame_geom.dtype,
                          device=frame_geom.device)
        wsum = torch.zeros(map_pts.shape[:-1], dtype=frame_geom.dtype, device=frame_geom.device)
        for idx_c, w_c in corners:
            gc = gather_rows(frame_geom, idx_c)
            wv = w_c * gc[..., 6]  # validity-masked bilinear weight
            acc = acc + wv[..., None] * gc[..., :6]
            wsum = wsum + wv
        g6 = acc / torch.clamp(wsum, min=1e-12)[..., None]
        s_cam = g6[..., :3]
        # a blend of unit normals is shorter than 1: renormalise
        n_cam = g6[..., 3:6]
        n_cam = n_cam / torch.clamp(torch.linalg.norm(n_cam, dim=-1, keepdim=True), min=1e-12)
        valid = valid & (wsum > 0.5)
    else:
        pix_w = torch.clamp(torch.round(u), 0, W - 1).to(torch.int64)
        pix_h = torch.clamp(torch.round(v), 0, H - 1).to(torch.int64)
        g = gather_rows(frame_geom, pix_h * W + pix_w)
        s_cam = g[..., :3]
        n_cam = g[..., 3:6]
        valid = valid & (g[..., 6] > 0.5)
    s = _rotate(s_cam, pose) + pose[:, None, :3, 3]
    if dist_thresh is not None:
        valid = valid & (torch.sum((s - map_pts) ** 2, dim=-1) < dist_thresh)
    n_world = _rotate(n_cam, pose)
    if dot_gate is not None:
        valid = valid & _normal_gate(n_world, map_normals, dot_gate)
    return s, valid, n_world


def _point_block(s, map_pts, valid, point_weight, robust_loss, robust_scale):
    """The point-to-point rows' weights ``sigma (B, N, 3)`` and weighted
    residuals ``sigma * (d - s)``: three rows an association at
    ``sqrt(point_weight)``, each robust-weighted on its own scaled
    component."""
    w = float(point_weight) ** 0.5
    diff = map_pts - s
    # one weight a row (three an association): the guard's mass counts rows
    sigma = (valid.to(s.dtype)[..., None] * w).expand(diff.shape)
    if robust_loss is not None:
        # scaling the residual and the scale alike keeps the weight a
        # function of the unscaled component, as in the row formulation
        sigma = sigma * robust_weights(w * diff, robust_loss, robust_scale * w)
    return sigma, sigma * diff


def _point_block_normal_eq(s, map_pts, valid, point_weight, robust_loss, robust_scale):
    r"""The point-to-point rows' share of the normal equations, folded
    analytically (``gradslam_tpu/odometry/projective.py:186``): row ``k`` of
    an association is ``sigma_k [e_k | s x e_k]`` with residual
    ``sigma_k (d_k - s_k)``, so ``A^T A`` and ``A^T b`` are summed from the
    ``(B, N, 3, 6)`` row blocks without stacking a ``(4N, 6)`` system onto
    the plane rows. Returns ``(AtA (B, 6, 6), Atb (B, 6, 1), errsq (B,),
    wmass (B,))``: the block's squared residual (the LM merit term) and its
    share of the step guard's mass, ``sum sigma^2``."""
    sigma, bw = _point_block(s, map_pts, valid, point_weight, robust_loss, robust_scale)
    zer = torch.zeros_like(s[..., 0])
    sx, sy, sz = s[..., 0], s[..., 1], s[..., 2]
    cross = torch.stack([
        torch.stack([zer, sz, -sy], dim=-1),  # s x e_0
        torch.stack([-sz, zer, sx], dim=-1),  # s x e_1
        torch.stack([sy, -sx, zer], dim=-1),  # s x e_2
    ], dim=-2)  # (B, N, 3, 3)
    eye = torch.eye(3, dtype=s.dtype, device=s.device).expand(cross.shape)
    Jw = torch.cat([eye, cross], dim=-1) * sigma[..., None]  # (B, N, 3, 6)
    AtA = torch.einsum("bnki,bnkj->bij", Jw, Jw)
    Atb = torch.einsum("bnki,bnk->bi", Jw, bw)[..., None]
    return AtA, Atb, torch.sum(bw * bw, dim=(1, 2)), torch.sum(sigma * sigma, dim=(1, 2))


def _projective_icp_core(
    mode: str,  # 'lm' (classic accept/reject) or 'gradlm'
    map_pts, map_normals, map_mask, frame_geom, intrinsics,
    init_pose,  # (B, 4, 4) predicted camera pose P
    initial_transform,  # (B, 4, 4) warm-start correction X0 or None
    H: int, W: int, numiters: int, damp: float,
    dist_thresh: Optional[float], dot_gate: Optional[float],
    lambda_max: float, B: float, B2: float, nu: float,
    lookahead_assoc: str, robust_loss: Optional[str], robust_scale: float,
    sym_normals: bool = False,
    point_weight: float = 0.0,
    subpixel: bool = False,
) -> torch.Tensor:
    """The LM or gradLM solve over world-space corrections ``X``: the
    camera pose is ``X @ init_pose``. Returns ``X (B, 4, 4)``."""
    if lookahead_assoc not in ("fresh", "reuse"):
        raise ValueError(f"Unknown lookahead_assoc mode: {lookahead_assoc}")
    if numiters < 1:
        raise ValueError(f"numiters must be >= 1. Got {numiters}.")
    nb = map_pts.shape[0]
    dtype, device = map_pts.dtype, map_pts.device
    X = (torch.eye(4, dtype=dtype, device=device).expand(nb, 4, 4)
         if initial_transform is None else initial_transform)
    damp_t = torch.full((nb,), damp, dtype=dtype, device=device)
    lambda_min = 1.0 / lambda_max
    eye6 = torch.eye(6, dtype=dtype, device=device)

    def associate(X):
        return projective_associate(
            map_pts, map_normals, map_mask, frame_geom, intrinsics,
            torch.matmul(X, init_pose), H, W, dist_thresh, dot_gate, subpixel,
        )

    def rows(s, valid, n_frame):
        n = map_normals
        if sym_normals:
            nsum = map_normals + n_frame
            n = nsum / torch.clamp(torch.linalg.norm(nsum, dim=-1, keepdim=True), min=1e-12)
        return _ptp_system(s, map_pts, n, valid, robust_loss, robust_scale)

    def errsq(s, valid, n_frame):
        """The merit ``sum b^2`` of the plane rows, and of the point rows
        when they are on (the lookahead needs no normal equations)."""
        b = rows(s, valid, n_frame)[1]
        err = torch.sum(b * b, dim=(1, 2))
        if point_weight > 0.0:
            bw = _point_block(s, map_pts, valid, point_weight, robust_loss, robust_scale)[1]
            err = err + torch.sum(bw * bw, dim=(1, 2))
        return err

    for _ in range(numiters):
        s, valid, n_frame = associate(X)
        A, b = rows(s, valid, n_frame)
        At = A.transpose(1, 2)
        AtA, Atb = torch.matmul(At, A), torch.matmul(At, b)
        err = torch.sum(b * b, dim=(1, 2))
        wmass = torch.sum(A[..., :3] ** 2, dim=(1, 2))
        if point_weight > 0.0:
            pAtA, pAtb, perr, pmass = _point_block_normal_eq(
                s, map_pts, valid, point_weight, robust_loss, robust_scale)
            AtA, Atb, err, wmass = AtA + pAtA, Atb + pAtb, err + perr, wmass + pmass
        xi, _info = torch.linalg.solve_ex(
            AtA + damp_t[:, None, None] * eye6, Atb, check_errors=False,
        )
        xi = xi[..., 0]  # (B, 6)
        if robust_loss is not None:
            xi = _guard_robust_step(xi, None, robust_scale, s, valid, wmass=wmass)
        residual_transform = se3_exp(xi)
        if lookahead_assoc == "reuse":
            # keep the association, move the frame points with the step
            s1 = _rotate(s, residual_transform) + residual_transform[:, None, :3, 3]
            valid1 = valid
            if dist_thresh is not None:
                valid1 = valid1 & (torch.sum((s1 - map_pts) ** 2, dim=-1) < dist_thresh)
            new_err = errsq(s1, valid1, n_frame)
        else:
            new_err = errsq(*associate(torch.matmul(residual_transform, X)))
        if mode == "lm":
            accept = new_err < err
            X = torch.where(accept[:, None, None], torch.matmul(residual_transform, X), X)
            damp_t = torch.where(accept, damp_t / 2.0, damp_t * 2.0)
        else:
            errdiff = torch.clamp(new_err - err, -70.0, 70.0)
            damp_new = lambda_min + (lambda_max - lambda_min) / (1.0 + torch.exp(-B * errdiff))
            sigmoid = 1.0 / (1.0 + torch.exp(-B2 * errdiff)) ** (1.0 / nu)
            X = torch.matmul(se3_exp(sigmoid[:, None] * xi), X)
            damp_t = damp_t * damp_new
    return X


def point_to_plane_ICP_projective(
    map_pts, map_normals, map_mask, frame_geom, intrinsics, init_pose,
    H: int, W: int,
    initial_transform=None,
    numiters: int = 20,
    damp: float = 1e-8,
    dist_thresh: Optional[float] = None,
    dot_gate: Optional[float] = None,
    lookahead_assoc: str = "fresh",
    robust_loss: Optional[str] = None,
    robust_scale: float = 0.05,
    sym_normals: bool = False,
    point_weight: float = 0.0,
    subpixel: bool = False,
) -> torch.Tensor:
    r"""Projective-association point-to-plane ICP with the classic LM
    accept/reject loop (the 1-NN :func:`~gradslam_torch.odometry.icputils.
    point_to_plane_ICP` with projection and gather in place of the 1-NN
    search), over a batch; inputs as
    :func:`point_to_plane_gradICP_projective`. Returns the world-space
    corrections ``X (B, 4, 4)``: the solved pose is ``X @ init_pose``."""
    return _projective_icp_core(
        "lm", map_pts, map_normals, map_mask, frame_geom, intrinsics, init_pose,
        initial_transform, H, W, numiters, damp, dist_thresh, dot_gate,
        2.0, 1.0, 1.0, 200.0, lookahead_assoc, robust_loss, robust_scale, sym_normals,
        point_weight, subpixel,
    )


def point_to_plane_gradICP_projective(
    map_pts, map_normals, map_mask, frame_geom, intrinsics, init_pose,
    H: int, W: int,
    initial_transform=None,
    numiters: int = 20,
    damp: float = 1e-8,
    dist_thresh: Optional[float] = None,
    dot_gate: Optional[float] = None,
    lambda_max: float = 2.0,
    B: float = 1.0,
    B2: float = 1.0,
    nu: float = 200.0,
    lookahead_assoc: str = "fresh",
    robust_loss: Optional[str] = None,
    robust_scale: float = 0.05,
    sym_normals: bool = False,
    point_weight: float = 0.0,
    subpixel: bool = False,
) -> torch.Tensor:
    r"""Projective-association gradLM ICP over a batch: map window
    ``(B, N, 3)`` points, normals and mask, frame image ``(B, H*W, 8)``,
    intrinsics and predicted poses ``(B, 4, 4)``. ``sym_normals`` uses the
    symmetric normal ``normalize(n_map + n_frame)`` in the rows;
    ``point_weight > 0`` adds three point-to-point rows an association at
    ``sqrt(point_weight)`` relative to the plane rows (folded into the 6x6
    system); ``subpixel`` associates with the bilinear blend of
    :func:`projective_associate`. Returns the
    world-space corrections ``X (B, 4, 4)``: the solved pose is
    ``X @ init_pose``."""
    return _projective_icp_core(
        "gradlm", map_pts, map_normals, map_mask, frame_geom, intrinsics, init_pose,
        initial_transform, H, W, numiters, damp, dist_thresh, dot_gate,
        lambda_max, B, B2, nu, lookahead_assoc, robust_loss, robust_scale, sym_normals,
        point_weight, subpixel,
    )


def pack_frame_geom(live_frame: RGBDImages) -> torch.Tensor:
    """The packed association image ``(B, H*W, 8)``: camera-frame vertex |
    normal | valid | 0."""
    Bn, _, H, W = live_frame.shape
    vert = live_frame.vertex_map.reshape(Bn, H * W, 3)
    nrm = live_frame.normal_map.reshape(Bn, H * W, 3)
    valid = live_frame.valid_depth_mask.reshape(Bn, H * W, 1).to(vert.dtype)
    return torch.cat([vert, nrm, valid, torch.zeros_like(valid)], dim=-1)


class ProjectiveOdometryProvider(OdometryProvider):
    r"""Frame-to-model odometry with projective data association and the
    gradLM solver (``solver='gradicp'``) or the classic LM solver
    (``solver='icp'``). ``dist_thresh`` is in squared metres; ``dot_gate``
    is a minimum cosine between the frame normal at the landed pixel and the
    map normal; ``sym_normals`` uses the symmetric normal in the rows;
    ``point_weight`` adds point-to-point rows at that weight and
    ``subpixel`` associates bilinearly (:func:`projective_associate`)."""

    def __init__(
        self,
        solver: str = "gradicp",
        numiters: int = 20,
        damp: float = 1e-8,
        dist_thresh=None,
        dot_gate: Optional[float] = None,
        lambda_max: float = 2.0,
        B: float = 1.0,
        B2: float = 1.0,
        nu: float = 200.0,
        lookahead_assoc: str = "fresh",
        robust_loss: Optional[str] = None,
        robust_scale: float = 0.05,
        sym_normals: bool = False,
        point_weight: float = 0.0,
        subpixel: bool = False,
    ):
        if solver not in ("icp", "gradicp"):
            raise ValueError(f"Unknown solver: {solver!r}. Expected 'icp' or 'gradicp'.")
        validate_robust(robust_loss, robust_scale)
        if dot_gate is not None and not (-1.0 <= dot_gate <= 1.0):
            raise ValueError(f"dot_gate must be a cosine in [-1, 1] or None. Got {dot_gate}.")
        if point_weight < 0:
            raise ValueError(f"point_weight must be >= 0. Got {point_weight}.")
        self.solver = solver
        self.numiters = numiters
        self.damp = damp
        self.dist_thresh = dist_thresh
        self.dot_gate = dot_gate
        self.lambda_max = lambda_max
        self.B = B
        self.B2 = B2
        self.nu = nu
        self.lookahead_assoc = lookahead_assoc
        self.robust_loss = robust_loss
        self.robust_scale = robust_scale
        self.sym_normals = bool(sym_normals)
        self.point_weight = float(point_weight)
        self.subpixel = bool(subpixel)

    def provide(
        self,
        maps_pointclouds: Pointclouds,
        live_frame: RGBDImages,
        initial_transform: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        r"""World-space corrections ``(B, 1, 4, 4)`` aligning the live frame
        to the map window: the solved pose is ``transform @ live_frame.poses``
        (``live_frame`` carries the predicted poses the solve starts from).
        ``initial_transform (B, 4, 4)`` warm-starts the solve and is included
        in the result."""
        if maps_pointclouds.normals is None:
            raise ValueError(
                "maps_pointclouds missing normals. Map normals must be "
                "provided if using ProjectiveOdometryProvider."
            )
        if not isinstance(live_frame, RGBDImages):
            raise TypeError(f"Expected live_frame to be of type RGBDImages. Got {type(live_frame)}.")
        if live_frame.poses is None:
            raise ValueError(
                "live_frame must carry poses (the initialization the projective solve starts from)."
            )
        if len(maps_pointclouds) != len(live_frame):
            raise ValueError(
                "Batch size of maps_pointclouds and live_frame should be "
                f"equal ({len(maps_pointclouds)} != {len(live_frame)})."
            )
        _, _, H, W = live_frame.shape
        kw = dict(
            initial_transform=initial_transform,
            numiters=self.numiters,
            damp=self.damp,
            dist_thresh=self.dist_thresh,
            dot_gate=self.dot_gate,
            lookahead_assoc=self.lookahead_assoc,
            robust_loss=self.robust_loss,
            robust_scale=self.robust_scale,
            sym_normals=self.sym_normals,
            point_weight=self.point_weight,
            subpixel=self.subpixel,
        )
        if self.solver == "gradicp":
            fn = point_to_plane_gradICP_projective
            kw.update(lambda_max=self.lambda_max, B=self.B, B2=self.B2, nu=self.nu)
        else:
            fn = point_to_plane_ICP_projective
        transform = fn(
            maps_pointclouds.points, maps_pointclouds.normals, maps_pointclouds.nonpad_mask,
            pack_frame_geom(live_frame), live_frame.intrinsics[:, 0], live_frame.poses[:, 0],
            H, W, **kw,
        )
        return transform[:, None]
