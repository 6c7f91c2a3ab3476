"""FAST-9/16 corner response, plain torch: a frozen copy of the port's
`fast_score_plain` (droplet_visual_odometry_tpu_torch/ops/cuda_fast.py), which
equals its CUDA kernel bit for bit. Every device runs the plain twin here."""

from __future__ import annotations

import torch


# Bresenham circle of radius 3 — (dy, dx) clockwise from 12 o'clock; the
# kernel's kDyList/kDxList tables hold the same offsets.
CIRCLE_OFFSETS: tuple[tuple[int, int], ...] = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)

BORDER = 3  # circle radius: pixels closer than this to an edge are never corners

# The kernel's pre-test reads these four neighbours first. A cyclic run of
# n >= 1 of the 16 covers at least n // 4 of them, so a pixel with fewer
# than compass_need(arc) hits of either polarity has no arc and scores 0.
COMPASS = (0, 4, 8, 12)


def compass_need(arc_length: int) -> int:
    """Compass hits per polarity a pixel needs to reach the full ring test
    (csrc/fast_score.cu:compass_need); 5 rejects all, as no arc > 16 exists."""
    if arc_length > 16:
        return 5
    return 0 if arc_length < 4 else arc_length // 4



def _max_circular_run(mask: torch.Tensor) -> torch.Tensor:
    """(16, ...) bool -> (...) int: longest circular run of True, by the
    doubled-ring running count (capped at 16)."""
    doubled = torch.cat([mask, mask], dim=0)
    run = doubled[0].to(torch.int32)
    best = run
    for i in range(1, 32):
        run = torch.where(doubled[i], run + 1, torch.zeros_like(run))
        best = torch.maximum(best, torch.clamp(run, max=16))
    return best


def fast_score_plain(img: torch.Tensor, threshold: float = 20.0, arc_length: int = 9) -> torch.Tensor:
    """FAST-N corner response of (..., H, W) float images -> float32, 0 for
    non-corners (port of droplet_visual_odometry_tpu/frontend/fast.py:fast_score).

    The excess sums accumulate in neighbour order j = 0..15, as the kernel does.
    """
    img = img.to(torch.float32)
    ring = torch.stack(
        [torch.roll(img, shifts=(-dy, -dx), dims=(-2, -1)) for dy, dx in CIRCLE_OFFSETS], dim=0
    )
    center = img[None]
    brighter = ring > center + threshold
    darker = ring < center - threshold
    is_corner = (_max_circular_run(brighter) >= arc_length) | (_max_circular_run(darker) >= arc_length)

    excess = torch.abs(ring - center) - threshold
    zero = torch.zeros_like(img)
    score_b = zero
    score_d = zero
    for j in range(16):
        score_b = score_b + torch.where(brighter[j], excess[j], zero)
        score_d = score_d + torch.where(darker[j], excess[j], zero)
    score = torch.maximum(score_b, score_d)

    h, w = img.shape[-2], img.shape[-1]
    yy = torch.arange(h, device=img.device)[:, None]
    xx = torch.arange(w, device=img.device)[None, :]
    in_bounds = (yy >= BORDER) & (yy < h - BORDER) & (xx >= BORDER) & (xx < w - BORDER)
    return torch.where(is_corner & in_bounds, score, zero)


fast_score_cuda = fast_score_plain

