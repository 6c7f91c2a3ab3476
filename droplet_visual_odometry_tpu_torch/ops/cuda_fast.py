"""FAST-9/16 corner response: the CUDA kernel csrc/fast_score.cu and its plain twin.

Replaces the TPU kernel droplet_visual_odometry_tpu/ops/pallas_fast.py:
_fast_score_impl (entry points fast_score_pallas_batch / fast_score_pallas).
Bound on the H100: a few dozen integer ops and 8 bytes of traffic per
pixel; the kernel stages a haloed tile in shared memory so each pixel is read
once and written once (design notes in the .cu file).

Dispatch: a CPU tensor goes to `fast_score_plain`; a CUDA tensor goes to the
kernel, or the call raises.
"""

from __future__ import annotations

import torch

from droplet_visual_odometry_tpu_torch.ops import build

# Bresenham circle of radius 3 — (dy, dx) clockwise from 12 o'clock; the
# kernel's kDy/kDx tables hold the same offsets.
CIRCLE_OFFSETS: tuple[tuple[int, int], ...] = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)

BORDER = 3  # circle radius: pixels closer than this to an edge are never corners

LAUNCHES = 0  # kernel launches made by fast_score_cuda


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


def fast_score_cuda(imgs: torch.Tensor, threshold: float = 20.0, arc_length: int = 9) -> torch.Tensor:
    """(N, H, W) float32 -> (N, H, W) float32 corner response.

    CUDA tensors run the hand-written kernel; CPU tensors run the plain twin.
    """
    if imgs.device.type == "cpu":
        return fast_score_plain(imgs, threshold, arc_length)
    if imgs.device.type != "cuda":
        raise ValueError(f"fast_score_cuda: unsupported device {imgs.device}")
    if imgs.dtype != torch.float32 or imgs.dim() != 3 or not imgs.is_contiguous():
        raise ValueError(
            f"fast_score_cuda: need a contiguous (N, H, W) float32 tensor, got "
            f"{tuple(imgs.shape)} {imgs.dtype} contiguous={imgs.is_contiguous()}"
        )
    n, h, w = imgs.shape
    out = torch.empty_like(imgs)
    if imgs.numel() == 0:
        return out
    global LAUNCHES
    lib = build.library()
    status = lib.dvo_fast_score(
        imgs.data_ptr(), out.data_ptr(), n, h, w, float(threshold), int(arc_length),
        build.current_stream_ptr(imgs.device),
    )
    LAUNCHES += 1
    build.check(status, "dvo_fast_score")
    return out
