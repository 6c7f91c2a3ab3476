"""Descriptor matching with cross-check / Lowe ratio — port of
droplet_visual_odometry_tpu/frontend/matcher.py, batched over frame pairs.

Binary (ORB) sets always go through the match reductions of
ops/cuda_match.py: kernel 3 on CUDA tensors, its plain twin on CPU tensors.
Sets of unequal size are padded to the larger with invalid entries, which
the reductions rank after every real one. Float (SIFT/SURF) sets go through
`l2_matrix`, one f32 matmul, as the reference computes them outside any
Pallas kernel. `match_crosscheck` and `match_ratio` are the reference's
matrix-form matchers over `hamming_matrix` (defined in ops/cuda_match.py) or
`l2_matrix`; the tests hold `match` equal to them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from plainref.ops.cuda_match import BIG, match_reductions_cuda


def l2_matrix(
    desc_a: torch.Tensor,
    desc_b: torch.Tensor,
    valid_a: torch.Tensor | None = None,
    valid_b: torch.Tensor | None = None,
) -> torch.Tensor:
    """(..., Ka, D) x (..., Kb, D) float descriptors -> (..., Ka, Kb) squared
    L2 distances |a|^2 + |b|^2 - 2 a.b (one f32 matmul, TF32 off), clamped
    at 0; invalid rows/cols are BIG."""
    a = desc_a.to(torch.float32)
    b = desc_b.to(torch.float32)
    dot = a @ b.transpose(-1, -2)
    na = torch.sum(a * a, dim=-1)
    nb = torch.sum(b * b, dim=-1)
    d2 = torch.clamp(na[..., :, None] + nb[..., None, :] - 2.0 * dot, min=0.0)
    if valid_a is not None:
        d2 = torch.where(valid_a[..., :, None], d2, torch.full_like(d2, BIG))
    if valid_b is not None:
        d2 = torch.where(valid_b[..., None, :], d2, torch.full_like(d2, BIG))
    return d2


class Matches(NamedTuple):
    """Per query keypoint (frame A): matched index into frame B, distance, validity."""

    idx: torch.Tensor  # (..., Ka) int64
    distance: torch.Tensor  # (..., Ka) float32
    valid: torch.Tensor  # (..., Ka) bool


def match_crosscheck(dist: torch.Tensor, max_distance: float = 256.0) -> Matches:
    """Mutual-nearest-neighbour matching on a (..., Ka, Kb) distance matrix."""
    best_b = torch.argmin(dist, dim=-1)
    best_a = torch.argmin(dist, dim=-2)
    d = torch.gather(dist, -1, best_b[..., None])[..., 0]
    rows = torch.arange(dist.shape[-2], device=dist.device)
    mutual = torch.gather(best_a, -1, best_b) == rows
    ok = mutual & (d <= max_distance) & (d < BIG)
    return Matches(idx=best_b, distance=d, valid=ok)


def match_ratio(dist: torch.Tensor, ratio: float = 0.75, max_distance: float = 256.0) -> Matches:
    """Lowe ratio-test matching: two smallest distances per row, lower index first on ties."""
    order = torch.sort(dist, dim=-1, stable=True).indices[..., :2]
    d12 = torch.gather(dist, -1, order)
    d1, d2 = d12[..., 0], d12[..., 1]
    ok = (d1 < ratio * d2) & (d1 <= max_distance) & (d1 < BIG)
    return Matches(idx=order[..., 0], distance=d1, valid=ok)


def match(
    desc_a: torch.Tensor,
    desc_b: torch.Tensor,
    valid_a: torch.Tensor | None = None,
    valid_b: torch.Tensor | None = None,
    mode: str = "crosscheck",
    ratio: float = 0.75,
    max_distance: float = 256.0,
) -> Matches:
    """Match (P, Ka, D) against (P, Kb, D) descriptor sets pairwise
    ('crosscheck' or 'ratio'): int32 packed ORB words (D = 8) or float
    SIFT/SURF vectors."""
    if mode not in ("crosscheck", "ratio"):
        raise ValueError(f"unknown match mode: {mode}")
    if desc_a.is_floating_point():
        # Squared L2: the ratio is specified on true distances, so square it.
        dist = l2_matrix(desc_a, desc_b, valid_a, valid_b)
        if mode == "crosscheck":
            return match_crosscheck(dist, max_distance=BIG / 2)
        return match_ratio(dist, ratio=ratio * ratio, max_distance=BIG / 2)

    p, ka, kb = desc_a.shape[0], desc_a.shape[1], desc_b.shape[1]
    dev = desc_a.device
    va = torch.ones((p, ka), dtype=torch.bool, device=dev) if valid_a is None else valid_a.to(torch.bool)
    vb = torch.ones((p, kb), dtype=torch.bool, device=dev) if valid_b is None else valid_b.to(torch.bool)
    k = max(ka, kb)
    # The reductions take equal sets: pad the smaller with invalid entries
    # (distance 512 in the reductions, after every real one; ties go to the
    # lower index), so no real row picks a padded column unless all its
    # columns are invalid, and then d1 is BIG and the match invalid.
    da, va = _pad_invalid(desc_a, va, k)
    db, vb = _pad_invalid(desc_b, vb, k)
    d1, i1, d2, col_best = match_reductions_cuda(da, db, va, vb)
    d1, d2 = d1[:, :ka], d2[:, :ka]
    i1 = torch.clamp(i1[:, :ka].to(torch.int64), max=kb - 1)
    if mode == "crosscheck":
        rows = torch.arange(ka, device=dev)
        ok = (torch.gather(col_best.to(torch.int64), -1, i1) == rows) & (d1 <= max_distance) & (d1 < BIG)
    else:
        ok = (d1 < ratio * d2) & (d1 <= max_distance) & (d1 < BIG)
    return Matches(idx=i1, distance=d1, valid=ok)


def _pad_invalid(desc: torch.Tensor, valid: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(P, K0, 8) words and (P, K0) mask padded to K entries, the new ones invalid."""
    pad = k - desc.shape[1]
    if pad:
        desc = torch.cat([desc, desc.new_zeros((desc.shape[0], pad, desc.shape[2]))], dim=1)
        valid = torch.cat([valid, valid.new_zeros((valid.shape[0], pad))], dim=1)
    return desc.contiguous(), valid.contiguous()


def gather_correspondences(
    xy_a: torch.Tensor, xy_b: torch.Tensor, m: Matches
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Matched coordinate pairs (fixed shape): (..., Ka, 2) prev points,
    (..., Ka, 2) curr points, (..., Ka) mask."""
    pts_b = torch.gather(xy_b, -2, m.idx[..., None].expand(m.idx.shape + (2,)))
    return xy_a, pts_b, m.valid
