"""FAST-9/16 detection stages — port of droplet_visual_odometry_tpu/frontend/fast.py.

The corner response itself has one definition, in ops/cuda_fast.py (kernel
and plain twin); `fast_score` here is that plain twin. NMS, the row-bucketed
top-k and the sub-pixel refinement stay plain torch, as the reference runs
them in XLA. All functions take a leading batch of frames.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from plainref.ops.cuda_fast import fast_score_cuda, fast_score_plain  # noqa: F401 (re-exports)

fast_score = fast_score_plain


class Keypoints(NamedTuple):
    """Fixed-K keypoint set (invalid slots masked), with leading batch dims."""

    xy: torch.Tensor  # (..., K, 2) float32 pixel coords (x, y)
    score: torch.Tensor  # (..., K) float32 corner response
    valid: torch.Tensor  # (..., K) bool


def nms3x3(score: torch.Tensor) -> torch.Tensor:
    """Keep only 3x3 local maxima of (..., H, W) score maps (ties keep both)."""
    h, w = score.shape[-2], score.shape[-1]
    m = F.max_pool2d(score.reshape(-1, 1, h, w), kernel_size=3, stride=1, padding=1)
    m = m.reshape(score.shape)
    return torch.where(score >= m, score, torch.zeros_like(score))


def subpixel_refine(score_map: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Per-axis parabola vertex through the 3 raw-score samples around each
    integer peak, clamped to +-0.5 and applied only at a confirmed maximum.

    score_map: (..., H, W); xy: (..., K, 2) integer-valued float coords.
    """
    h, w = score_map.shape[-2], score_map.shape[-1]
    flat = score_map.reshape(score_map.shape[:-2] + (h * w,))
    xi = xy[..., 0].to(torch.int64)
    yi = xy[..., 1].to(torch.int64)

    def at(dy: int, dx: int) -> torch.Tensor:
        idx = torch.clamp(yi + dy, 0, h - 1) * w + torch.clamp(xi + dx, 0, w - 1)
        return torch.gather(flat, -1, idx)

    s0 = at(0, 0)

    def vertex(sm: torch.Tensor, sp: torch.Tensor) -> torch.Tensor:
        den = sm - 2.0 * s0 + sp
        d = torch.where(den < -1e-9, 0.5 * (sm - sp) / den, torch.zeros_like(den))
        return torch.clamp(d, -0.5, 0.5)

    off = torch.stack([vertex(at(0, -1), at(0, 1)), vertex(at(-1, 0), at(1, 0))], dim=-1)
    return xy + off


def select_topk_rows(score_map: torch.Tensor, k: int, per_row: int | None = None) -> Keypoints:
    """Row-bucketed top-k of (..., H, W) NMS'd score maps: the strongest
    `per_row` corners of every row, then a global top-k over H * per_row
    candidates.

    Ties resolve as jax.lax.top_k does — the lower candidate index first —
    through a stable descending sort (torch.topk promises no tie order, and
    integer FAST scores tie often); torch.argmax returns the first maximum.
    """
    lead = score_map.shape[:-2]
    h, w = score_map.shape[-2], score_map.shape[-1]
    if per_row is None:
        per_row = max(3, -(-2 * k // h))
    s = score_map
    cols = torch.arange(w, device=s.device)
    cand_v, cand_x = [], []
    for _ in range(per_row):
        i = torch.argmax(s, dim=-1)  # (..., H)
        cand_v.append(torch.gather(s, -1, i[..., None])[..., 0])
        cand_x.append(i)
        s = torch.where(cols == i[..., None], torch.zeros_like(s), s)
    vals = torch.stack(cand_v, dim=-1).reshape(lead + (h * per_row,))
    xs = torch.stack(cand_x, dim=-1).reshape(lead + (h * per_row,))
    ys = torch.arange(h, device=s.device).repeat_interleave(per_row).expand(lead + (h * per_row,))
    if vals.shape[-1] < k:  # tiny images: pad so the top-k is well-defined
        pad = k - vals.shape[-1]
        vals = torch.cat([vals, vals.new_zeros(lead + (pad,))], dim=-1)
        xs = torch.cat([xs, xs.new_zeros(lead + (pad,))], dim=-1)
        ys = torch.cat([ys, ys.new_zeros(lead + (pad,))], dim=-1)
    order = torch.sort(vals, dim=-1, descending=True, stable=True).indices[..., :k]
    top_v = torch.gather(vals, -1, order)
    xy = torch.stack(
        [torch.gather(xs, -1, order).to(torch.float32), torch.gather(ys, -1, order).to(torch.float32)],
        dim=-1,
    )
    return Keypoints(xy=xy, score=top_v, valid=top_v > 0.0)


def detect(img: torch.Tensor, k: int = 512, threshold: float = 20.0, arc_length: int = 9) -> Keypoints:
    """FAST score, 3x3 NMS and the row-bucketed top-k of (..., H, W) frames.

    The score runs through ops/cuda_fast.fast_score_cuda: the kernel on a
    CUDA tensor, its plain twin on a CPU tensor.
    """
    h, w = img.shape[-2], img.shape[-1]
    frames = img.to(torch.float32).reshape(-1, h, w).contiguous()
    score = fast_score_cuda(frames, threshold, arc_length).reshape(img.shape)
    return select_topk_rows(nms3x3(score), k)
