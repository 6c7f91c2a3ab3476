"""ORB describe (patch gather, moments, angle bin, steered BRIEF bits), plain
torch: a frozen copy of the port's `describe_plain` and its tables
(droplet_visual_odometry_tpu_torch/ops/cuda_describe.py), whose words equal
its CUDA kernel's bit for bit with TF32 off. Every device runs the plain twin."""

from __future__ import annotations

import functools

import numpy as np
import torch

from plainref.ops.cuda_match import N_BITS

N_WORDS = N_BITS // 32
PATCH = 37  # patch side; supports rotated samples with radius <= 18
HALF = PATCH // 2
PATTERN_RADIUS = 13  # max sample offset magnitude before rotation
ANGLE_BINS = 30  # 12-degree quantisation



def _make_pattern(seed: int = 7) -> np.ndarray:
    """(256, 2, 2) int offsets (dy, dx) for the two test points of each bit."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(scale=PATTERN_RADIUS / 2.0, size=(N_BITS, 2, 2))
    return np.clip(np.round(pts), -PATTERN_RADIUS, PATTERN_RADIUS).astype(np.int32)


_PATTERN = _make_pattern()


def _build_pair_table() -> np.ndarray:
    """(ANGLE_BINS, 256, 2) int16: flat patch positions [p1, p2] of the two
    test points of each bit, rotated into each angle bin and clipped to the
    patch, as the reference's _build_steer_weights places its +-1 entries."""
    dy = _PATTERN[..., 0].astype(np.float32)
    dx = _PATTERN[..., 1].astype(np.float32)
    table = np.empty((ANGLE_BINS, N_BITS, 2), np.int16)
    for b in range(ANGLE_BINS):
        a = 2.0 * np.pi * b / ANGLE_BINS
        c, s = np.float32(np.cos(a)), np.float32(np.sin(a))
        ry = np.clip(np.round(s * dx + c * dy), -HALF, HALF).astype(np.int32) + HALF
        rx = np.clip(np.round(c * dx - s * dy), -HALF, HALF).astype(np.int32) + HALF
        table[b] = ry * PATCH + rx
    return table


_PAIRS = _build_pair_table()


def _build_steer_weights() -> np.ndarray:
    """(PATCH*PATCH, 2 + ANGLE_BINS*N_BITS) float32 steering matrix: columns
    0/1 are the disc moment weights wy/wx; column 2 + b*N_BITS + j is +1 at
    the bin-b second test point of pair j and -1 at the first."""
    w = np.zeros((PATCH * PATCH, 2 + ANGLE_BINS * N_BITS), np.float32)
    d = np.arange(PATCH, dtype=np.float32) - HALF
    yy, xx = np.meshgrid(d, d, indexing="ij")
    disc = (yy * yy + xx * xx) <= (HALF * HALF)
    w[:, 0] = np.where(disc, yy, 0.0).reshape(-1)
    w[:, 1] = np.where(disc, xx, 0.0).reshape(-1)
    for b in range(ANGLE_BINS):
        cols = 2 + b * N_BITS + np.arange(N_BITS)
        # += so coincident p1/p2 (possible after clipping) cancel to 0 -> bit 0.
        np.add.at(w, (_PAIRS[b, :, 1], cols), 1.0)
        np.add.at(w, (_PAIRS[b, :, 0], cols), -1.0)
    return w


# Small integers, so this f32 table equals the reference's bf16 _STEER_W exactly.
_STEER_W = _build_steer_weights()


@functools.lru_cache(maxsize=None)
def _steer_w(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_STEER_W).to(device)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(..., 256) bool -> (..., 8) int32 by the reference's log-tree of
    pairwise or/shift combines: bit j lands in word j // 32 at bit j % 32."""
    v = bits.to(torch.int64)
    width = 1
    while v.shape[-1] > N_WORDS:
        v = v[..., 0::2] | (v[..., 1::2] << width)
        width *= 2
    return torch.where(v >= 2**31, v - 2**32, v).to(torch.int32)


def _check_origins(origins: torch.Tensor, n: int, h: int, w: int) -> None:
    o = origins.cpu()
    bad = (
        (o[:, 0] < 0) | (o[:, 0] >= n)
        | (o[:, 1] < 0) | (o[:, 1] > h - PATCH)
        | (o[:, 2] < 0) | (o[:, 2] > w - PATCH)
    )
    if bool(bad.any()):
        i = int(torch.nonzero(bad)[0, 0])
        raise ValueError(
            f"patch origin {o[i].tolist()} out of range for {n} frames of {h}x{w}"
        )


def extract_patches_plain(imgs: torch.Tensor, origins: torch.Tensor, check: bool = False) -> torch.Tensor:
    """(N, H, W) float + (M, 3) int [frame, y0, x0] -> (M, 37, 37) float32
    (port of droplet_visual_odometry_tpu/frontend/orb.py:extract_patches,
    batched over frames by the origins' frame column)."""
    imgs = imgs.to(torch.float32)
    n, h, w = imgs.shape
    if check:
        _check_origins(origins, n, h, w)
    o = origins.to(torch.int64)
    r = torch.arange(PATCH, device=imgs.device)
    rows = (o[:, 1, None] + r)[:, :, None]  # (M, P, 1)
    cols = (o[:, 2, None] + r)[:, None, :]  # (M, 1, P)
    return imgs[o[:, 0, None, None], rows, cols]


def describe_plain(
    imgs_blur: torch.Tensor, origins: torch.Tensor, check: bool = False
) -> tuple[torch.Tensor, torch.Tensor]:
    """(N, H, W) blurred images + (M, 3) origins -> ((M, 8) int32 descriptors,
    (M,) float32 angles), by the reference's steering-matmul chain.

    The f32 matmul runs with TF32 off (PyTorch's default): every product and
    partial sum is an integer below 2**24, so it is exact in any order and
    equals the reference's bf16 x bf16 -> f32 product.
    """
    m = origins.shape[0]
    patches = extract_patches_plain(imgs_blur, origins, check)
    q = torch.round(patches.reshape(m, PATCH * PATCH))
    feats = q @ _steer_w(q.device)  # (M, 2 + 30*256)
    # Contiguous moments: on the CPU, atan2 of strided views takes another
    # code path than of contiguous tensors, and the two differ by an ulp.
    ang = torch.atan2(feats[:, 0].contiguous(), feats[:, 1].contiguous())
    # Divide by a tensor: CUDA turns division by a Python scalar into a
    # multiply by its reciprocal, which rounds differently from the CPU.
    two_pi = torch.full_like(ang, 2.0 * np.pi)
    bin_idx = torch.remainder(torch.round(ang / two_pi * ANGLE_BINS), ANGLE_BINS).to(torch.int64)
    allbits = feats[:, 2:].reshape(m, ANGLE_BINS, N_BITS)
    sel = torch.gather(allbits, 1, bin_idx[:, None, None].expand(m, 1, N_BITS))[:, 0]
    return pack_bits(sel > 0), ang


describe_cuda = describe_plain

