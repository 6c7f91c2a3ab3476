"""Metric scale from the fiducial marker — port of
droplet_visual_odometry_tpu/estimation/scale.py, batched over pairs.

`marker_scale_gn` (the default estimator) fits (marker pose, log scale) to
both frames' marker corners by 5 Gauss-Newton steps with the relative pose
held fixed; `marker_side_length` is the reference's corner-triangulation
estimator. Every function takes leading batch dimensions (the P pairs of a
sequence); K is shared.
"""

from __future__ import annotations

import torch

from plainref.core import se3
from plainref.estimation.epipolar import det3
from plainref.estimation.triangulate import dehomogenize, triangulate_points
from plainref.ops import linalg as fast_linalg
from plainref.utils.device import constant


def marker_side_length(
    K: torch.Tensor,
    R: torch.Tensor,
    t: torch.Tensor,
    prev_corners_px: torch.Tensor,
    curr_corners_px: torch.Tensor,
    side: str = "mean",
) -> torch.Tensor:
    """Triangulated marker side length under a unit-|t| relative pose.
    R (..., 3, 3), t (..., 3), corners (..., 4, 2) -> (...,)."""
    eye_z = torch.cat(
        [torch.eye(3, dtype=K.dtype, device=K.device), torch.zeros((3, 1), dtype=K.dtype, device=K.device)], dim=1
    )
    P1 = (K @ eye_z).expand(R.shape[:-2] + (3, 4))
    P2 = K @ torch.cat([R, t[..., :, None]], dim=-1)
    X = dehomogenize(triangulate_points(P1, P2, prev_corners_px, curr_corners_px))  # (..., 4, 3)

    def dist(i, j):
        return torch.linalg.vector_norm(X[..., i, :] - X[..., j, :], dim=-1)

    if side == "reference":
        return dist(0, 1)
    return torch.stack([dist(0, 1), dist(1, 2), dist(2, 3), dist(3, 0)], dim=-1).mean(-1)


def canonical_corners(L, dtype=torch.float32, device="cpu") -> torch.Tensor:
    """Marker corners in the marker frame, (4, 3), in the synthetic/STag winding."""
    s = L / 2.0
    return constant(((-s, -s, 0.0), (s, -s, 0.0), (s, s, 0.0), (-s, s, 0.0)), dtype, torch.device(device))


def square_pnp(corners_px: torch.Tensor, K: torch.Tensor, L: float) -> torch.Tensor:
    """cTm (..., 4, 4) of a known-size square from its (..., 4, 2) image corners:
    homography DLT by the fixed-cost eigensolver, Zhang decomposition,
    orthonormalised by the fixed-cost SVD, t_z > 0."""
    dev, dtype = corners_px.device, corners_px.dtype
    obj = canonical_corners(L, dtype, dev)[:, :2]
    x = (corners_px[..., 0] - K[0, 2]) / K[0, 0]
    y = (corners_px[..., 1] - K[1, 2]) / K[1, 1]
    u = (obj[:, 0] / L).expand(x.shape)
    v = (obj[:, 1] / L).expand(x.shape)
    zeros, ones = torch.zeros_like(u), torch.ones_like(u)
    r1 = torch.stack([u, v, ones, zeros, zeros, zeros, -u * x, -v * x, -x], dim=-1)
    r2 = torch.stack([zeros, zeros, zeros, u, v, ones, -u * y, -v * y, -y], dim=-1)
    A = torch.cat([r1, r2], dim=-2)  # (..., 8, 9)
    h = fast_linalg.smallest_eigvec(A.transpose(-1, -2) @ A)
    H = h.reshape(h.shape[:-1] + (3, 3))
    g1, g2, g3 = H[..., :, 0] * (1.0 / L), H[..., :, 1] * (1.0 / L), H[..., :, 2]
    lam = 2.0 / torch.clamp(
        torch.linalg.vector_norm(g1, dim=-1) + torch.linalg.vector_norm(g2, dim=-1), min=1e-12
    )
    sign = torch.where(g3[..., 2] * lam < 0, -torch.ones_like(lam), torch.ones_like(lam))
    sl = (sign * lam)[..., None]
    r1c, r2c, t = sl * g1, sl * g2, sl * g3
    R_raw = torch.stack([r1c, r2c, fast_linalg._cross(r1c, r2c)], dim=-1)
    U, _, Vt = fast_linalg.svd3x3(R_raw)
    R = U @ Vt
    R = R * torch.sign(det3(R))[..., None, None]
    bottom = constant((0.0, 0.0, 0.0, 1.0), dtype, dev).expand(R.shape[:-2] + (1, 4))
    return torch.cat([torch.cat([R, t[..., :, None]], dim=-1), bottom], dim=-2)


def _project(K: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    z = torch.clamp(X[..., 2:3], min=1e-9)
    xy = X[..., :2] / z
    return xy * torch.stack([K[0, 0], K[1, 1]]) + torch.stack([K[0, 2], K[1, 2]])


def marker_scale_gn(
    K: torch.Tensor,
    R: torch.Tensor,
    t_unit: torch.Tensor,
    prev_corners_px: torch.Tensor,
    curr_corners_px: torch.Tensor,
    L: float,
    iters: int = 5,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Joint GN fit of (cTm_prev, log scale) to both frames' marker corners,
    with R (..., 3, 3) and t_unit (..., 3) held fixed: 16 residuals, 7
    parameters, analytic Jacobian. Returns (scale (...,), converged_ok (...,))."""
    dev, dtype = prev_corners_px.device, prev_corners_px.dtype
    batch = prev_corners_px.shape[:-2]
    model = canonical_corners(L, dtype, dev)
    M0 = square_pnp(prev_corners_px, K, L)
    target = torch.cat([prev_corners_px, curr_corners_px], dim=-2).reshape(batch + (16,))
    M0c = square_pnp(curr_corners_px, K, L)
    s_init = torch.linalg.vector_norm(M0c[..., :3, 3] - (R @ M0[..., :3, 3, None])[..., 0], dim=-1)
    ls0 = torch.log(torch.clamp(s_init, 1e-6, 1e6))
    fx, fy = K[0, 0], K[1, 1]
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    Rt = R.transpose(-1, -2)

    def residual(M, ls):
        s = torch.exp(ls)
        X1 = model @ M[..., :3, :3].transpose(-1, -2) + M[..., None, :3, 3]  # (..., 4, 3)
        X2 = X1 @ Rt + (s[..., None] * t_unit)[..., None, :]
        pred = torch.cat([_project(K, X1), _project(K, X2)], dim=-2)
        return pred.reshape(batch + (16,)) - target, X1, X2, s

    def dproj(X):  # (..., 4, 3) -> (..., 4, 2, 3)
        x, y = X[..., 0], X[..., 1]
        z = torch.clamp(X[..., 2], min=1e-9)
        zeros = torch.zeros_like(z)
        row_u = torch.stack([fx / z, zeros, -fx * x / (z * z)], dim=-1)
        row_v = torch.stack([zeros, fy / z, -fy * y / (z * z)], dim=-1)
        return torch.stack([row_u, row_v], dim=-2)

    M, ls = M0, ls0
    best = torch.full(batch, float("inf"), dtype=dtype, device=dev)
    for _ in range(iters):
        r, X1, X2, s = residual(M, ls)
        dX1 = torch.cat([eye3.expand(X1.shape[:-1] + (3, 3)), -se3._hat(X1)], dim=-1)  # (..., 4, 3, 6)
        J1 = dproj(X1) @ dX1  # (..., 4, 2, 6)
        A2 = dproj(X2)
        J2 = A2 @ R[..., None, :, :] @ dX1
        Jls = (A2 @ (s[..., None] * t_unit)[..., None, :, None])[..., 0]  # (..., 4, 2)
        top = torch.cat([J1, torch.zeros(J1.shape[:-1] + (1,), dtype=dtype, device=dev)], dim=-1)
        bot = torch.cat([J2, Jls[..., None]], dim=-1)
        J = torch.cat([top, bot], dim=-3).reshape(batch + (16, 7))
        JtJ = J.transpose(-1, -2) @ J
        damp = 1e-6 * torch.diagonal(JtJ, dim1=-2, dim2=-1).sum(-1) / 7.0 + 1e-12
        dx = fast_linalg.solve_spd(JtJ, -(J.transpose(-1, -2) @ r[..., None])[..., 0], eps=damp)
        M_new = se3.se3_exp(dx[..., :6]) @ M
        ls_new = ls + dx[..., 6]
        r_new = residual(M_new, ls_new)[0]
        better = torch.sum(r_new**2, dim=-1) <= torch.sum(r**2, dim=-1)
        M = torch.where(better[..., None, None], M_new, M)
        ls = torch.where(better, ls_new, ls)
        best = torch.minimum(best, torch.sum(torch.where(better[..., None], r_new, r) ** 2, dim=-1))
    s = torch.exp(ls)
    rms = torch.sqrt(best / 16.0)
    return s, torch.isfinite(s) & (rms < 20.0)


def scale_factor_with_valid(
    K: torch.Tensor,
    R: torch.Tensor,
    t: torch.Tensor,
    prev_corners_px: torch.Tensor,
    curr_corners_px: torch.Tensor,
    real_marker_length: float,
    marker_valid: torch.Tensor,
    side: str = "mean",
    max_scale: float = 1e3,
    estimator: str = "gn",
) -> tuple[torch.Tensor, torch.Tensor]:
    """(scale, scale_ok) per pair: the live marker scale, or 1.0 with
    scale_ok False when the marker is absent or the fit is not sane."""
    if estimator == "gn":
        s, fit_ok = marker_scale_gn(K, R, t, prev_corners_px, curr_corners_px, real_marker_length)
    elif estimator == "triangulation":
        measured = marker_side_length(K, R, t, prev_corners_px, curr_corners_px, side)
        s = real_marker_length / torch.clamp(measured, min=1e-12)
        fit_ok = torch.ones_like(s, dtype=torch.bool)
    else:
        raise ValueError(f"unknown scale estimator: {estimator}")
    good = marker_valid & fit_ok & torch.isfinite(s) & (s > 0) & (s < max_scale)
    return torch.where(good, s, torch.ones_like(s)), good


def scale_factor(
    K: torch.Tensor,
    R: torch.Tensor,
    t: torch.Tensor,
    prev_corners_px: torch.Tensor,
    curr_corners_px: torch.Tensor,
    real_marker_length: float,
    marker_valid: torch.Tensor,
    side: str = "mean",
    max_scale: float = 1e3,
) -> torch.Tensor:
    """scaling_factor = real_marker_length / measured length (v3:281, 322)
    by the default estimator, or 1.0 where the marker is absent or the fit
    degenerates (the reference itself would crash there)."""
    s, _ = scale_factor_with_valid(
        K, R, t, prev_corners_px, curr_corners_px, real_marker_length, marker_valid, side, max_scale
    )
    return s
