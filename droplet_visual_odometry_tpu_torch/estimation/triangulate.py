"""Projection-matrix DLT triangulation (cv.triangulatePoints parity) — port of
droplet_visual_odometry_tpu/estimation/triangulate.py, batched over leading dims.

Like the reference, it takes the eigenvector of the 4x4 normal matrix from
the library eigensolver (jnp.linalg.eigh there, torch.linalg.eigh here).
"""

from __future__ import annotations

import torch


def triangulate_points(
    P1: torch.Tensor, P2: torch.Tensor, pts1_px: torch.Tensor, pts2_px: torch.Tensor
) -> torch.Tensor:
    """P1, P2 (..., 3, 4); pts (..., N, 2) pixels -> (..., N, 4) homogeneous points."""

    def rows(P, x):
        r1 = x[..., 0:1, None] * P[..., None, 2:3, :] - P[..., None, 0:1, :]
        r2 = x[..., 1:2, None] * P[..., None, 2:3, :] - P[..., None, 1:2, :]
        return torch.cat([r1, r2], dim=-2)  # (..., N, 2, 4)

    A = torch.cat([rows(P1, pts1_px), rows(P2, pts2_px)], dim=-2)  # (..., N, 4, 4)
    A = A / torch.clamp(torch.linalg.vector_norm(A, dim=-1, keepdim=True), min=1e-12)
    _, vecs = torch.linalg.eigh(A.transpose(-1, -2) @ A)
    return vecs[..., :, 0]


def dehomogenize(Xh: torch.Tensor) -> torch.Tensor:
    """(..., 4) -> (..., 3) with the sign fixed so w > 0."""
    w = Xh[..., 3:4]
    sign = torch.where(w == 0, torch.ones_like(w), torch.sign(w))
    return Xh[..., :3] * sign / torch.clamp(torch.abs(w), min=1e-12)
