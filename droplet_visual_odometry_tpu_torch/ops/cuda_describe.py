"""ORB describe: the CUDA kernel csrc/orb_describe.cu, its plain twin, and the tables.

Replaces the TPU kernel droplet_visual_odometry_tpu/ops/pallas_patches.py:
extract_patches_pallas together with the steering matmul, angle bin and bit
pack that follow it in droplet_visual_odometry_tpu/frontend/orb.py:
describe_batch. Contract: blurred level images (N, H, W) float32 and clamped
patch origins (M, 3) int32 [frame, y0, x0] give (M, 8) int32 descriptors
(the reference's uint32 words bit for bit) and (M,) float32 angles.

The plain twin, `describe_plain`, is the reference's chain: gather the
37x37 patches, round them, multiply by the 1369 x 7682 steering matrix
`_STEER_W` in f32, take atan2 of the two moment columns, bin the angle,
keep the bin's 256 columns and pack their signs. On the card that matmul is
258 GFLOP for a 24-frame 1440x1080 run. The kernel computes the same bits
without it: column 2 + b*256 + j of `_STEER_W` is +1 at the bin-b second test
point of pair j and -1 at the first, so bit j is `q[p2] > q[p1]` (false when
the two coincide), and the moments are integer sums, exact in any order. The
kernel reads each patch once from device memory, so its bound is the bytes
of the patches (design notes in the .cu file).

Dispatch: CPU tensors go to `describe_plain`; CUDA tensors go to the
kernel, or the call raises. `check=True` verifies on the host that the
origins lie in range, and raises otherwise.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from droplet_visual_odometry_tpu_torch.ops import build
from droplet_visual_odometry_tpu_torch.ops.cuda_match import N_BITS

N_WORDS = N_BITS // 32
PATCH = 37  # patch side; supports rotated samples with radius <= 18
HALF = PATCH // 2
PATTERN_RADIUS = 13  # max sample offset magnitude before rotation
ANGLE_BINS = 30  # 12-degree quantisation

LAUNCHES = 0  # kernel launches made by describe_cuda


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


@functools.lru_cache(maxsize=None)
def _pair_table(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_PAIRS).to(device)


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


def describe_cuda(
    imgs_blur: torch.Tensor, origins: torch.Tensor, check: bool = False
) -> tuple[torch.Tensor, torch.Tensor]:
    """(N, H, W) float32 blurred images + (M, 3) int32 clamped origins ->
    ((M, 8) int32 descriptors, (M,) float32 angles).

    CUDA tensors run the hand-written kernel; CPU tensors run the plain twin.
    """
    if imgs_blur.device.type == "cpu" and origins.device.type == "cpu":
        return describe_plain(imgs_blur, origins, check)
    if imgs_blur.device.type != "cuda" or origins.device != imgs_blur.device:
        raise ValueError(f"describe_cuda: images on {imgs_blur.device}, origins on {origins.device}")
    if imgs_blur.dtype != torch.float32 or imgs_blur.dim() != 3 or not imgs_blur.is_contiguous():
        raise ValueError(
            f"describe_cuda: need contiguous (N, H, W) float32 images, got "
            f"{tuple(imgs_blur.shape)} {imgs_blur.dtype}"
        )
    if origins.dtype != torch.int32 or origins.dim() != 2 or origins.shape[1] != 3 or not origins.is_contiguous():
        raise ValueError(
            f"describe_cuda: need contiguous (M, 3) int32 origins, got {tuple(origins.shape)} {origins.dtype}"
        )
    n, h, w = imgs_blur.shape
    if h < PATCH or w < PATCH:
        raise ValueError(f"describe_cuda: images {h}x{w} smaller than the {PATCH}px patch")
    if check:
        _check_origins(origins, n, h, w)
    m = origins.shape[0]
    desc = torch.empty((m, N_WORDS), dtype=torch.int32, device=imgs_blur.device)
    ang = torch.empty((m,), dtype=torch.float32, device=imgs_blur.device)
    if m == 0:
        return desc, ang
    global LAUNCHES
    lib = build.library()
    status = lib.dvo_orb_describe(
        imgs_blur.data_ptr(), origins.data_ptr(), _pair_table(imgs_blur.device).data_ptr(),
        desc.data_ptr(), ang.data_ptr(), m, h, w, build.current_stream_ptr(imgs_blur.device),
    )
    LAUNCHES += 1
    build.check(status, "dvo_orb_describe")
    return desc, ang
