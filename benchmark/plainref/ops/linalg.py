"""Fixed-cost batched small-matrix linear algebra — port of
droplet_visual_odometry_tpu/ops/linalg.py.

The same algorithms as the reference, clamps included: unrolled Cholesky,
inverse iteration for the smallest eigenvector, one-sided Jacobi 3x3 SVD.
They are written over a batch dimension in plain torch; torch.linalg is not
used, because its numerics and failure modes (exceptions on non-SPD input,
data-dependent iteration) differ from the reference's.

In eager torch every scalar step below is its own launch on the device; the
chains are short and batched over all hypotheses of all pairs at once.
"""

from __future__ import annotations

import torch


def cholesky_unrolled(A: torch.Tensor, eps: float | torch.Tensor = 0.0) -> torch.Tensor:
    """Batched Cholesky of (..., n, n) SPD matrices: lower L with
    A + eps*I = L L^T. No pivoting; pivots are clamped at 1e-30."""
    n = A.shape[-1]
    L: list[list[torch.Tensor | None]] = [[None] * n for _ in range(n)]
    for j in range(n):
        s = A[..., j, j] + eps
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        d = torch.sqrt(torch.clamp(s, min=1e-30))
        L[j][j] = d
        inv_d = 1.0 / d
        for i in range(j + 1, n):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv_d
    zero = torch.zeros_like(L[0][0])
    rows = [torch.stack([L[i][j] if j <= i else zero for j in range(n)], dim=-1) for i in range(n)]
    return torch.stack(rows, dim=-2)


def cholesky_solve(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve (L L^T) x = b by unrolled forward/back substitution; b (..., n)."""
    n = L.shape[-1]
    y: list[torch.Tensor] = [None] * n  # type: ignore[list-item]
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[..., i, k] * y[k]
        y[i] = s / L[..., i, i]
    x: list[torch.Tensor] = [None] * n  # type: ignore[list-item]
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[..., k, i] * x[k]
        x[i] = s / L[..., i, i]
    return torch.stack(x, dim=-1)


def solve_spd(A: torch.Tensor, b: torch.Tensor, eps: float | torch.Tensor = 0.0) -> torch.Tensor:
    """Solve SPD (..., n, n) @ x = (..., n) via unrolled Cholesky."""
    return cholesky_solve(cholesky_unrolled(A, eps=eps), b)


def smallest_eigvec(AtA: torch.Tensor, iters: int = 3) -> torch.Tensor:
    """Eigenvector of the smallest eigenvalue of SPSD (..., n, n): inverse
    iteration with a trace-relative shift (1e-5 * tr / n)."""
    n = AtA.shape[-1]
    tr = torch.diagonal(AtA, dim1=-2, dim2=-1).sum(-1)
    eye = torch.eye(n, dtype=AtA.dtype, device=AtA.device)
    L = cholesky_unrolled(AtA + (1e-5 * tr / n + 1e-30)[..., None, None] * eye)
    v = torch.ones(AtA.shape[:-1], dtype=AtA.dtype, device=AtA.device)
    fallback = torch.full_like(v, 1.0 / n**0.5)
    for _ in range(iters):
        v = cholesky_solve(L, v)
        norm = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
        good = torch.isfinite(norm) & (norm > 0)
        v = torch.where(good, v / torch.clamp(norm, min=1e-30), fallback)
    return v


JACOBI_SWEEPS = 6


def sym_smallest_eigvec(A: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector of the smallest eigenvalue of symmetric (..., n, n)
    matrices by JACOBI_SWEEPS cyclic Jacobi sweeps (Golub and Van Loan,
    alg. 8.4.3), each rotation applied to rows and columns p and q only. No
    host read and no library eigensolver (whose CUDA path synchronizes with
    the host), so a CUDA graph can hold it. `smallest_eigvec`'s three inverse
    iterations do not do here: on a short baseline the normal matrix's two
    smallest eigenvalues lie within its trace shift, and at a 0.005 baseline
    its points are 0.81 of the depth from a float64 solve, against the
    reference eigensolver's 0.055 and these sweeps' 0.0024
    (tests/test_torch_estimation.py::test_triangulate_points_jacobi_agrees).
    Sign as the eigensolver's: arbitrary."""
    n = A.shape[-1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    M = torch.cat([A, eye.expand(A.shape)], dim=-2)  # A over V: both take the column rotations
    for _ in range(JACOBI_SWEEPS):
        for p in range(n - 1):
            for q in range(p + 1, n):
                app, aqq, apq = M[..., p, p], M[..., q, q], M[..., p, q]
                tiny = torch.abs(apq) < 1e-30
                tau = (aqq - app) / (2.0 * torch.where(tiny, torch.ones_like(apq), apq))
                t = torch.where(tau >= 0, 1.0, -1.0) / (torch.abs(tau) + torch.sqrt(1.0 + tau * tau))
                t = torch.where(tiny, torch.zeros_like(t), t)
                c = (1.0 / torch.sqrt(1.0 + t * t))[..., None]
                s = t[..., None] * c
                mp, mq = M[..., :, p], M[..., :, q]
                M[..., :, p], M[..., :, q] = c * mp - s * mq, s * mp + c * mq
                ap, aq = M[..., p, :], M[..., q, :]
                M[..., p, :], M[..., q, :] = c * ap - s * aq, s * ap + c * aq
    idx = torch.argmin(torch.diagonal(M[..., :n, :], dim1=-2, dim2=-1), dim=-1)
    V = M[..., n:, :]
    return torch.gather(V, -1, idx[..., None, None].expand(V.shape[:-1] + (1,)))[..., 0]


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack(
        [
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
        ],
        dim=-1,
    )


def svd3x3(E: torch.Tensor, jacobi_sweeps: int = 6) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fixed-cost batched SVD of (..., 3, 3) by one-sided Jacobi rotations.
    Returns (U, S, Vt), S descending, U right-handed (reference semantics)."""
    a = list(E.unbind(-1))  # columns of A
    eye = torch.eye(3, dtype=E.dtype, device=E.device).expand(E.shape)
    v = list(eye.unbind(-1))  # columns of V
    for _ in range(jacobi_sweeps):
        for p, q in ((0, 1), (0, 2), (1, 2)):
            ap, aq = a[p], a[q]
            app = torch.sum(ap * ap, dim=-1)
            aqq = torch.sum(aq * aq, dim=-1)
            apq = torch.sum(ap * aq, dim=-1)
            tiny = torch.abs(apq) < 1e-30
            tau = (aqq - app) / (2.0 * torch.where(tiny, torch.full_like(apq, 1e-30), apq))
            t = torch.sign(tau) / (torch.abs(tau) + torch.sqrt(1.0 + tau * tau))
            t = torch.where(tiny, torch.zeros_like(t), t)
            c = 1.0 / torch.sqrt(1.0 + t * t)
            s = c * t
            a[p], a[q] = c[..., None] * ap - s[..., None] * aq, s[..., None] * ap + c[..., None] * aq
            vp, vq = v[p], v[q]
            v[p], v[q] = c[..., None] * vp - s[..., None] * vq, s[..., None] * vp + c[..., None] * vq
    A = torch.stack(a, dim=-1)
    V = torch.stack(v, dim=-1)
    S = torch.linalg.vector_norm(A, dim=-2)
    order = torch.argsort(-S, dim=-1, stable=True)
    S = torch.gather(S, -1, order)
    idx = order[..., None, :].expand(A.shape)
    A = torch.gather(A, -1, idx)
    V = torch.gather(V, -1, idx)
    U0 = A[..., :, 0] / torch.clamp(S[..., 0:1], min=1e-30)
    U1 = A[..., :, 1] / torch.clamp(S[..., 1:2], min=1e-30)
    U2 = _cross(U0, U1)
    U2 = U2 / torch.clamp(torch.linalg.vector_norm(U2, dim=-1, keepdim=True), min=1e-30)
    # Flip V's third column with a left-handed orthogonalised A (see reference).
    s3 = torch.sign(torch.sum(A[..., :, 2] * U2, dim=-1))
    s3 = torch.where(s3 == 0, torch.ones_like(s3), s3)
    V = torch.cat([V[..., :, :2], V[..., :, 2:] * s3[..., None, None]], dim=-1)
    U = torch.stack([U0, U1, U2], dim=-1)
    return U, S, V.transpose(-1, -2)
