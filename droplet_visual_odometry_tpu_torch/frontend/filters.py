"""Separable Gaussian blur and antialiased resize — port of
droplet_visual_odometry_tpu/frontend/filters.py.

Both stay plain torch: the reference computes them in XLA, outside any Pallas
kernel. Their bf16 roundings follow the reference's dtypes (see each function).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch


@functools.lru_cache(maxsize=32)
def _gaussian_taps(sigma: float, radius: int) -> tuple[float, ...]:
    xs = [math.exp(-0.5 * (i / sigma) ** 2) for i in range(-radius, radius + 1)]
    s = sum(xs)
    return tuple(x / s for x in xs)


def _pad_replicate(a: torch.Tensor, r: int, dim: int) -> torch.Tensor:
    first = a.narrow(dim, 0, 1)
    last = a.narrow(dim, a.shape[dim] - 1, 1)
    reps = [1] * a.dim()
    reps[dim] = r
    return torch.cat([first.repeat(reps), a, last.repeat(reps)], dim=dim)


def _blur_pass(x: torch.Tensor, taps: torch.Tensor, dim: int, last_add_dtype: torch.dtype | None = None) -> torch.Tensor:
    r = (taps.numel() - 1) // 2
    n = x.shape[dim]
    xp = _pad_replicate(x, r, dim)
    acc = xp.narrow(dim, 0, n) * taps[0]
    for i in range(1, taps.numel()):
        sl = xp.narrow(dim, i, n) * taps[i]
        if i == taps.numel() - 1 and last_add_dtype is not None:
            acc, sl = acc.to(last_add_dtype), sl.to(last_add_dtype)
        acc = acc + sl
    return acc


def gaussian_blur(
    img: torch.Tensor,
    sigma: float = 2.0,
    radius: int | None = None,
    compute_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Separable Gaussian blur of (..., H, W) float images (edge-replicated),
    as 2*(2r+1) scaled shifted adds.

    compute_dtype=torch.bfloat16 rounds as the reference's compiled bf16
    chain does: input and taps in bf16, every product and add rounded to
    bf16 — except the very last add, which XLA fuses with the cast back to
    the input dtype and so computes unrounded in that dtype. Rounding that
    add too would move up to half a bf16 ulp, enough to flip the integer
    rounding of describe's patches.
    """
    if radius is None:
        radius = max(1, int(3.0 * sigma + 0.5))
    in_dtype = img.dtype
    x = img if compute_dtype is None else img.to(compute_dtype)
    taps = torch.tensor(_gaussian_taps(float(sigma), radius), dtype=torch.float32, device=img.device)
    taps = taps.to(x.dtype)
    x = _blur_pass(x, taps, x.dim() - 2)
    return _blur_pass(x, taps, x.dim() - 1, last_add_dtype=in_dtype).to(in_dtype)


@functools.lru_cache(maxsize=64)
def _resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) antialiased triangle-kernel weights, columns sum to 1
    (jax.image.resize(method='linear', antialias=True) convention)."""
    scale = n_in / n_out
    support = max(scale, 1.0)
    c = (np.arange(n_out) + 0.5) * scale - 0.5
    j = np.arange(n_in)
    w = np.maximum(0.0, 1.0 - np.abs(j[:, None] - c[None, :]) / support)
    w /= w.sum(axis=0, keepdims=True)
    return w.astype(np.float32)


def resize_bilinear(img: torch.Tensor, new_h: int, new_w: int) -> torch.Tensor:
    """Antialiased linear resize of (..., H, W) to (..., new_h, new_w).

    The reference multiplies bf16 operands with f32 accumulation and rounds
    the intermediate to bf16 between the two products. Here the operands are
    rounded to bf16 and multiplied as f32 (every bf16 x bf16 product is exact
    in f32); a bf16 torch.matmul would return a bf16 result instead.
    """
    h, w = img.shape[-2], img.shape[-1]

    def bf16_f32(a):
        return a.to(torch.bfloat16).to(torch.float32)

    Wh = bf16_f32(torch.from_numpy(_resize_weights(h, new_h)).to(img.device))
    Ww = bf16_f32(torch.from_numpy(_resize_weights(w, new_w)).to(img.device))
    t = torch.matmul(Wh.T, bf16_f32(img))  # (..., new_h, W)
    return torch.matmul(bf16_f32(t), Ww)  # (..., new_h, new_w)
