"""Rotation-aware binary (rBRIEF-style) descriptors — port of
droplet_visual_odometry_tpu/frontend/orb.py.

Same pattern, same steering, same bit packing as the reference: a 37x37
patch per keypoint, rounded to integers; the intensity-centroid moments give
the angle, the angle bin selects 256 rotated BRIEF tests, and their results
are packed into 8 words. The whole stage is one call per pyramid level to
ops/cuda_describe.describe_cuda (kernel 2 on CUDA, the reference's
steering-matmul chain on the CPU), which also holds the pattern, the
steering and pair tables and `pack_bits`; they are re-exported here.

Descriptors are (..., K, 8) int32 tensors holding the reference's uint32
words bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from plainref.ops.cuda_describe import HALF, N_WORDS, PATCH, describe_cuda, extract_patches_plain
from plainref.ops.cuda_match import unpack_bits_pm1  # noqa: F401 (re-export)


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
    ij = torch.stack([ij[..., 0].clamp(0, h - PATCH), ij[..., 1].clamp(0, w - PATCH)], dim=-1)
    fidx = torch.arange(n, dtype=torch.int32, device=xy.device)[:, None].expand(n, k)
    return torch.cat([fidx.reshape(n * k, 1), ij.reshape(n * k, 2)], dim=-1).contiguous()


def describe_batch(imgs_blur: torch.Tensor, xy: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(N, H, W) blurred frames + (N, K, 2) keypoints -> ((N, K, 8) int32
    descriptors, (N, K) angles)."""
    n, h, w = imgs_blur.shape
    k = xy.shape[1]
    desc, ang = describe_cuda(imgs_blur.to(torch.float32).contiguous(), patch_origins(xy, h, w))
    return desc.reshape(n, k, N_WORDS), ang.reshape(n, k)


def describe(img_blur: torch.Tensor, kps) -> tuple[torch.Tensor, torch.Tensor]:
    """One (H, W) blurred frame + its Keypoints (K) -> ((K, 8) int32
    descriptors, (K,) angles): describe_batch on a batch of one."""
    desc, ang = describe_batch(img_blur[None], kps.xy[None])
    return desc[0], ang[0]


def extract_patches(imgs: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """(N, H, W) images + (N, K, 2) keypoints -> (N, K, 37, 37) float32 patches
    centred on the integer-rounded keypoints, clamped into the image (the
    reference's plain vmap(dynamic_slice) gather, as one index gather)."""
    n, h, w = imgs.shape
    k = xy.shape[1]
    return extract_patches_plain(imgs, patch_origins(xy, h, w)).reshape(n, k, PATCH, PATCH)

