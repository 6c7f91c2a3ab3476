"""Per-frame multi-scale detect + orient + describe — port of
droplet_visual_odometry_tpu/frontend/features.py (ORB mode).

Each pyramid level is an antialiased bf16 resize of the previous one; on
every level the FAST score (kernel 1) runs once over the whole batch of
frames, then NMS, the row-bucketed top-k, the bf16 blur, the descriptor
(kernel 2 for the patches) and the sub-pixel refinement, with coordinates
mapped back to level-0 pixels. Per-level budgets are static, so the output
always holds exactly K keypoints per frame.
"""

from __future__ import annotations

import torch

from droplet_visual_odometry_tpu_torch.frontend import fast, filters
from droplet_visual_odometry_tpu_torch.frontend.orb import HALF, Features, describe_batch

N_LEVELS = 4
SCALE_FACTOR = 1.32


def level_shapes(h: int, w: int, n_levels: int, scale_factor: float) -> list[tuple[int, int]]:
    """Static per-level (H_l, W_l); never below 64 px per axis (or the input)."""
    out = [(h, w)]
    for l in range(1, n_levels):
        s = scale_factor**l
        out.append((max(int(round(h / s)), min(64, h)), max(int(round(w / s)), min(64, w))))
    return out


def level_budgets(k: int, n_levels: int, scale_factor: float) -> list[int]:
    """Static per-level keypoint counts summing exactly to k (OpenCV's
    geometric nfeatures split)."""
    raw = [scale_factor ** (-l) for l in range(n_levels)]
    total = sum(raw)
    ks = [max(int(round(k * r / total)), 8) for r in raw]
    ks[0] += k - sum(ks)
    if ks[0] < 8:
        raise ValueError(f"keypoint budget {k} too small for {n_levels} levels")
    return ks


def _orb_level(
    level_imgs: torch.Tensor,  # (N, H_l, W_l) float32
    k_level: int,
    threshold: float,
    arc_length: int,
    h0: int,
    w0: int,
) -> Features:
    """Detect + describe one pyramid level; coords mapped to level-0 pixels."""
    n, lh, lw = level_imgs.shape
    score = fast.fast_score_cuda(level_imgs.contiguous(), threshold, arc_length)
    kps = fast.select_topk_rows(fast.nms3x3(score), k_level)
    blur = filters.gaussian_blur(level_imgs, sigma=2.0, radius=4, compute_dtype=torch.bfloat16)
    desc, ang = describe_batch(blur, kps.xy)

    x, y = kps.xy[..., 0], kps.xy[..., 1]
    interior = (x >= HALF) & (x < lw - HALF) & (y >= HALF) & (y < lh - HALF)

    xy_ref = fast.subpixel_refine(score, kps.xy)
    xr, yr = xy_ref[..., 0], xy_ref[..., 1]
    sx, sy = w0 / lw, h0 / lh
    xy0 = torch.stack([(xr + 0.5) * sx - 0.5, (yr + 0.5) * sy - 0.5], dim=-1)
    return Features(xy=xy0, score=kps.score, angle=ang, desc=desc, valid=kps.valid & interior)


def detect_and_describe_batch(
    imgs: torch.Tensor,
    k: int = 512,
    threshold: float = 20.0,
    arc_length: int = 9,
    mode: str = "orb",
    dog_threshold: float = 1.0,
    n_levels: int = N_LEVELS,
    scale_factor: float = SCALE_FACTOR,
) -> Features:
    """(N, H, W) frames -> Features with a leading N axis and K = k keypoints
    per frame over all pyramid levels (coordinates in level-0 pixels)."""
    if mode in ("sift", "surf"):
        raise NotImplementedError(
            f"frontend {mode!r} is not ported yet (ROADMAP A12: frontend/sift.py, frontend/surf.py)"
        )
    if mode != "orb":
        raise ValueError(f"unknown frontend mode: {mode}")

    imgs = imgs.to(torch.float32)
    n, h0, w0 = imgs.shape
    shapes = level_shapes(h0, w0, n_levels, scale_factor)
    budgets = level_budgets(k, n_levels, scale_factor)
    parts = []
    level_imgs = imgs
    for l in range(n_levels):
        if l > 0:
            level_imgs = filters.resize_bilinear(level_imgs, *shapes[l])
        parts.append(_orb_level(level_imgs, budgets[l], threshold, arc_length, h0, w0))
    if n_levels == 1:
        return parts[0]
    return Features(*(torch.cat(xs, dim=1) for xs in zip(*parts)))
