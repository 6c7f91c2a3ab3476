"""Two-view epipolar geometry — port of droplet_visual_odometry_tpu/estimation/epipolar.py.

Batched 8-point essential matrices, Sampson error and E -> (R, t) recovery
with cheirality voting. Leading dimensions are batch dimensions (pairs,
hypotheses); where the reference is written for one pair under vmap, the
pair dimension is written out here.

Conventions (OpenCV): E satisfies x2^T E x1 = 0 in normalized coords, and
recover_pose returns curr_T_prev with |t| = 1.
"""

from __future__ import annotations

import torch

from plainref.ops import linalg as fast_linalg
from plainref.utils.device import constant


def to_normalized(pts_px: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Pixel (..., 2) -> normalized homogeneous camera coords (..., 3)."""
    x = (pts_px[..., 0] - K[0, 2]) / K[0, 0]
    y = (pts_px[..., 1] - K[1, 2]) / K[1, 1]
    return torch.stack([x, y, torch.ones_like(x)], dim=-1)


def _hartley_normalize(x: torch.Tensor, w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Weighted Hartley normalisation of (..., N, 3) points with (..., N)
    weights -> (x_normalised, T (..., 3, 3)), x_norm = x @ T^T."""
    wsum = torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-9)
    mean = torch.sum(x[..., :2] * w[..., None], dim=-2, keepdim=True) / wsum[..., None]
    centred = x[..., :2] - mean
    rms = torch.sqrt(torch.sum(torch.sum(centred * centred, dim=-1) * w, dim=-1, keepdim=True) / wsum / 2.0)
    s = 1.0 / torch.clamp(rms, min=1e-9)
    mx, my, sb = mean[..., 0, 0], mean[..., 0, 1], s[..., 0]
    zeros, ones = torch.zeros_like(sb), torch.ones_like(sb)
    T = torch.stack([sb, zeros, -sb * mx, zeros, sb, -sb * my, zeros, zeros, ones], dim=-1)
    T = T.reshape(x.shape[:-2] + (3, 3))
    xn = torch.cat([centred * s[..., None], x[..., 2:]], dim=-1)
    return xn, T


def essential_8point(
    x1: torch.Tensor,
    x2: torch.Tensor,
    w: torch.Tensor,
    enforce_rank2: bool = True,
    hartley: bool = True,
    eig_iters: int = 3,
) -> torch.Tensor:
    """Weighted 8-point algorithm over (..., N, 3) correspondences and (..., N)
    weights -> E (..., 3, 3), by fixed-cost inverse iteration (ops/linalg).
    hartley=False requires pre-conditioned inputs (RANSAC normalises once
    globally)."""
    if hartley:
        x1n, T1 = _hartley_normalize(x1, w)
        x2n, T2 = _hartley_normalize(x2, w)
    else:
        x1n, x2n = x1, x2
    A = (x2n[..., :, None] * x1n[..., None, :]).reshape(x1.shape[:-1] + (9,))
    AtA = (A * w[..., None]).transpose(-1, -2) @ A
    e = fast_linalg.smallest_eigvec(AtA, iters=eig_iters)
    E = e.reshape(e.shape[:-1] + (3, 3))
    if hartley:
        E = T2.transpose(-1, -2) @ E @ T1
    if enforce_rank2:
        E = project_to_essential(E)
    return E


def project_to_essential(E: torch.Tensor) -> torch.Tensor:
    """Nearest essential matrix: singular values -> (1, 1, 0)."""
    U, S, Vt = fast_linalg.svd3x3(E)
    d = constant((1.0, 1.0, 0.0), E.dtype, E.device)
    return U @ (d[:, None] * Vt)


def sampson_error(E: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """First-order geometric (Sampson) error of B hypotheses on N points.

    E: (..., B, 3, 3); x1, x2: (..., N, 3) with the same leading dims ->
    (..., B, N)."""
    Ef = E.reshape(E.shape[:-2] + (9,))
    A = (x2[..., :, :, None] * x1[..., :, None, :]).reshape(x1.shape[:-1] + (9,))
    num = Ef @ A.transpose(-1, -2)
    Ex1 = E @ x1.transpose(-1, -2)[..., None, :, :]  # (..., B, 3, N)
    Etx2 = E.transpose(-1, -2) @ x2.transpose(-1, -2)[..., None, :, :]
    den = Ex1[..., 0, :] ** 2 + Ex1[..., 1, :] ** 2 + Etx2[..., 0, :] ** 2 + Etx2[..., 1, :] ** 2
    return num**2 / torch.clamp(den, min=1e-12)


def det3(M: torch.Tensor) -> torch.Tensor:
    """Determinant of (..., 3, 3) by cofactor expansion."""
    return (
        M[..., 0, 0] * (M[..., 1, 1] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 1])
        - M[..., 0, 1] * (M[..., 1, 0] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 0])
        + M[..., 0, 2] * (M[..., 1, 0] * M[..., 2, 1] - M[..., 1, 1] * M[..., 2, 0])
    )


def decompose_essential(E: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """E -> four (R, t) candidates: (..., 4, 3, 3) and (..., 4, 3)."""
    U, _, Vt = fast_linalg.svd3x3(E)
    U = U * torch.sign(det3(U))[..., None, None]
    Vt = Vt * torch.sign(det3(Vt))[..., None, None]
    W = constant(((0.0, -1.0, 0.0), (1.0, 0.0, 0.0), (0.0, 0.0, 1.0)), E.dtype, E.device)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[..., :, 2]
    return torch.stack([R1, R1, R2, R2], dim=-3), torch.stack([t, -t, t, -t], dim=-2)


def triangulate_two_view(
    R: torch.Tensor, t: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor
) -> torch.Tensor:
    """Linear triangulation in normalized coords with camera 1 at [I|0] and
    camera 2 at [R|t]; x1, x2: (..., N, 3) rays -> (..., N, 3) points in
    camera-1 coords (inhomogeneous DLT normal equations, unrolled Cholesky)."""
    batch = torch.broadcast_shapes(R.shape[:-2], x1.shape[:-2])
    n = x1.shape[-2]
    I0 = torch.cat(
        [torch.eye(3, dtype=R.dtype, device=R.device), torch.zeros((3, 1), dtype=R.dtype, device=R.device)],
        dim=-1,
    )
    P1 = I0.expand(batch + (3, 4))
    P2 = torch.cat([R, t[..., :, None]], dim=-1).expand(batch + (3, 4))
    x1 = x1.expand(batch + (n, 3))
    x2 = x2.expand(batch + (n, 3))

    def rows(P, x):
        p0, p1, p2 = (P[..., i, :][..., None, :] for i in range(3))
        r1 = x[..., 0][..., None] * p2 - p0
        r2 = x[..., 1][..., None] * p2 - p1
        return torch.stack([r1, r2], dim=-2)  # (..., N, 2, 4)

    A = torch.cat([rows(P1, x1), rows(P2, x2)], dim=-2)  # (..., N, 4, 4)
    M = A[..., :3]
    d = A[..., 3]
    MtM = M.transpose(-1, -2) @ M
    Mtd = (M.transpose(-1, -2) @ d[..., None])[..., 0]
    tr = (MtM[..., 0, 0] + MtM[..., 1, 1] + MtM[..., 2, 2])[..., None, None]
    reg = 1e-7 * tr * torch.eye(3, dtype=A.dtype, device=A.device)
    return fast_linalg.solve_spd(MtM + reg, -Mtd)


def recover_pose(
    E: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor, w: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pick the (R, t) of the four E decompositions with the best weighted
    cheirality vote (cv.recoverPose parity).

    E (..., 3, 3); x1, x2 (..., N, 3); w (..., N) -> R (..., 3, 3), t (..., 3),
    in_front (..., N) bool for the winning pose."""
    Rs, ts = decompose_essential(E)
    X1 = triangulate_two_view(Rs, ts, x1[..., None, :, :], x2[..., None, :, :])  # (..., 4, N, 3)
    X2 = X1 @ Rs.transpose(-1, -2) + ts[..., :, None, :]
    front = (X1[..., 2] > 0) & (X2[..., 2] > 0)
    votes = torch.sum(front * w[..., None, :], dim=-1)
    best = torch.argmax(votes, dim=-1)
    R = torch.gather(Rs, -3, best[..., None, None, None].expand(best.shape + (1, 3, 3)))[..., 0, :, :]
    t = torch.gather(ts, -2, best[..., None, None].expand(best.shape + (1, 3)))[..., 0, :]
    f = torch.gather(front, -2, best[..., None, None].expand(best.shape + (1, front.shape[-1])))[..., 0, :]
    return R, t, f
