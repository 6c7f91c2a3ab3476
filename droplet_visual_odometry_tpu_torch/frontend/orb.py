"""Rotation-aware binary (rBRIEF-style) descriptors — port of
droplet_visual_odometry_tpu/frontend/orb.py.

Same pattern, same steering table, same bit packing as the reference: a
37x37 patch per keypoint (kernel 2, ops/cuda_patches.py), rounded to
integers, times the constant steering matrix whose first two columns give
the intensity-centroid moments and whose other 30 x 256 columns give every
rotated BRIEF test; the keypoint's angle bin selects 256 of them, their signs
are the bits, and a log-tree of pairwise combines packs them into 8 words.

The steering product is an f32 torch.matmul with TF32 off: every product
and partial sum is an integer below 2**24, so it is exact in any order and
equals the reference's bf16 x bf16 -> f32 product. (A bf16 torch.matmul
would return bf16 and round the moment columns.)

Descriptors are (..., K, 8) int32 tensors holding the reference's uint32
words bit for bit.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from droplet_visual_odometry_tpu_torch.ops.cuda_match import N_BITS, unpack_bits_pm1  # noqa: F401 (re-export)
from droplet_visual_odometry_tpu_torch.ops.cuda_patches import PATCH, extract_patches_cuda

N_WORDS = N_BITS // 32
HALF = PATCH // 2
PATTERN_RADIUS = 13  # max sample offset magnitude before rotation
ANGLE_BINS = 30  # 12-degree quantisation


def _make_pattern(seed: int = 7) -> np.ndarray:
    """(256, 2, 2) int offsets (dy, dx) for the two test points of each bit."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(scale=PATTERN_RADIUS / 2.0, size=(N_BITS, 2, 2))
    return np.clip(np.round(pts), -PATTERN_RADIUS, PATTERN_RADIUS).astype(np.int32)


_PATTERN = _make_pattern()


def _build_steer_weights() -> np.ndarray:
    """(PATCH*PATCH, 2 + ANGLE_BINS*N_BITS) float32 steering matrix: columns
    0/1 are the disc moment weights wy/wx; column 2 + b*N_BITS + j is +1 at
    the bin-b-rotated second test point of pair j and -1 at the first."""
    w = np.zeros((PATCH * PATCH, 2 + ANGLE_BINS * N_BITS), np.float32)
    d = np.arange(PATCH, dtype=np.float32) - HALF
    yy, xx = np.meshgrid(d, d, indexing="ij")
    disc = (yy * yy + xx * xx) <= (HALF * HALF)
    w[:, 0] = np.where(disc, yy, 0.0).reshape(-1)
    w[:, 1] = np.where(disc, xx, 0.0).reshape(-1)

    dy = _PATTERN[..., 0].astype(np.float32)
    dx = _PATTERN[..., 1].astype(np.float32)
    for b in range(ANGLE_BINS):
        a = 2.0 * np.pi * b / ANGLE_BINS
        c, s = np.float32(np.cos(a)), np.float32(np.sin(a))
        ry = np.clip(np.round(s * dx + c * dy), -HALF, HALF).astype(np.int32) + HALF
        rx = np.clip(np.round(c * dx - s * dy), -HALF, HALF).astype(np.int32) + HALF
        pos = ry * PATCH + rx
        cols = 2 + b * N_BITS + np.arange(N_BITS)
        # += so coincident p1/p2 (possible after clipping) cancel to 0 -> bit 0.
        np.add.at(w, (pos[:, 1], cols), 1.0)
        np.add.at(w, (pos[:, 0], cols), -1.0)
    return w


# Small integers, so this f32 table equals the reference's bf16 _STEER_W exactly.
_STEER_W = _build_steer_weights()


@functools.lru_cache(maxsize=None)
def _steer_w(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_STEER_W).to(device)


class Features(NamedTuple):
    """Fixed-K feature set with leading batch dims — the unit the matcher consumes."""

    xy: torch.Tensor  # (..., K, 2) float32
    score: torch.Tensor  # (..., K)
    angle: torch.Tensor  # (..., K)
    desc: torch.Tensor  # (..., K, 8) int32 packed 256-bit descriptors
    valid: torch.Tensor  # (..., K) bool


def patch_origins(xy: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(N, K, 2) keypoints -> (N*K, 3) int32 [frame, y0, x0] patch origins,
    centred on the integer-rounded keypoint and clamped into the image."""
    n, k = xy.shape[0], xy.shape[1]
    ij = torch.round(torch.stack([xy[..., 1], xy[..., 0]], dim=-1)).to(torch.int32) - HALF
    hi = torch.tensor([h - PATCH, w - PATCH], dtype=torch.int32, device=xy.device)
    ij = torch.minimum(torch.clamp(ij, min=0), hi)
    fidx = torch.arange(n, dtype=torch.int32, device=xy.device)[:, None].expand(n, k)
    return torch.cat([fidx.reshape(n * k, 1), ij.reshape(n * k, 2)], dim=-1).contiguous()


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(..., 256) bool -> (..., 8) int32 by the reference's log-tree of
    pairwise or/shift combines (a fixed bit permutation of the pattern)."""
    v = bits.to(torch.int64)
    width = 1
    while v.shape[-1] > N_WORDS:
        v = v[..., 0::2] | (v[..., 1::2] << width)
        width *= 2
    return torch.where(v >= 2**31, v - 2**32, v).to(torch.int32)


def describe_batch(imgs_blur: torch.Tensor, xy: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(N, H, W) blurred frames + (N, K, 2) keypoints -> ((N, K, 8) int32
    descriptors, (N, K) angles)."""
    n, h, w = imgs_blur.shape
    k = xy.shape[1]
    imgs_blur = imgs_blur.to(torch.float32).contiguous()
    patches = extract_patches_cuda(imgs_blur, patch_origins(xy, h, w))  # (N*K, P, P)
    q = torch.round(patches.reshape(n * k, PATCH * PATCH))
    feats = q @ _steer_w(imgs_blur.device)  # (NK, 2 + 30*256), exact in f32
    ang = torch.atan2(feats[:, 0], feats[:, 1])
    # Divide by a tensor: CUDA turns division by a Python scalar into a
    # multiply by its reciprocal, which rounds differently from the CPU.
    two_pi = torch.full_like(ang, 2.0 * np.pi)
    bin_idx = torch.remainder(torch.round(ang / two_pi * ANGLE_BINS), ANGLE_BINS).to(torch.int64)
    allbits = feats[:, 2:].reshape(n * k, ANGLE_BINS, N_BITS)
    sel = torch.gather(allbits, 1, bin_idx[:, None, None].expand(n * k, 1, N_BITS))[:, 0]
    return pack_bits(sel > 0).reshape(n, k, N_WORDS), ang.reshape(n, k)


