"""Descriptor matching with cross-check / Lowe ratio — port of
droplet_visual_odometry_tpu/frontend/matcher.py, batched over frame pairs.

`match` always goes through the match reductions of ops/cuda_match.py:
kernel 3 on CUDA tensors, its plain twin on CPU tensors. `match_crosscheck`
and `match_ratio` are the reference's matrix-form matchers over
`hamming_matrix` (defined in ops/cuda_match.py); the tests hold `match`
equal to them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from droplet_visual_odometry_tpu_torch.ops.cuda_match import BIG, hamming_matrix, match_reductions_cuda  # noqa: F401


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
    """Match (P, K, 8) descriptor sets pairwise ('crosscheck' or 'ratio')."""
    if desc_a.is_floating_point():
        raise NotImplementedError(
            "float (SIFT/SURF) descriptor matching is not ported yet (ROADMAP A12: matcher.l2_matrix)"
        )
    if desc_a.shape != desc_b.shape:
        raise ValueError(f"match: equal descriptor sets required, got {tuple(desc_a.shape)} vs {tuple(desc_b.shape)}")
    p, k = desc_a.shape[0], desc_a.shape[1]
    ones = torch.ones((p, k), dtype=torch.bool, device=desc_a.device)
    va = ones if valid_a is None else valid_a.to(torch.bool).contiguous()
    vb = ones if valid_b is None else valid_b.to(torch.bool).contiguous()
    d1, i1, d2, col_best = match_reductions_cuda(desc_a.contiguous(), desc_b.contiguous(), va, vb)
    i1 = i1.to(torch.int64)
    if mode == "crosscheck":
        rows = torch.arange(k, device=desc_a.device)
        ok = (torch.gather(col_best.to(torch.int64), -1, i1) == rows) & (d1 <= max_distance) & (d1 < BIG)
    elif mode == "ratio":
        ok = (d1 < ratio * d2) & (d1 <= max_distance) & (d1 < BIG)
    else:
        raise ValueError(f"unknown match mode: {mode}")
    return Matches(idx=i1, distance=d1, valid=ok)


def gather_correspondences(
    xy_a: torch.Tensor, xy_b: torch.Tensor, m: Matches
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Matched coordinate pairs (fixed shape): (..., Ka, 2) prev points,
    (..., Ka, 2) curr points, (..., Ka) mask."""
    pts_b = torch.gather(xy_b, -2, m.idx[..., None].expand(m.idx.shape + (2,)))
    return xy_a, pts_b, m.valid
