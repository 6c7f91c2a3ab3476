"""Per-keypoint patch gather: the CUDA kernel csrc/extract_patches.cu and its plain twin.

Replaces the TPU kernel droplet_visual_odometry_tpu/ops/pallas_patches.py:
extract_patches_pallas. Bound on the H100: a pure copy (~67 MB written for a
24-frame 1440x1080 run), so only bytes matter; the kernel gives each keypoint
one block whose threads read and write patch rows coalesced.

Dispatch: a CPU tensor goes to `extract_patches_plain`; a CUDA tensor goes to
the kernel, or the call raises. Origins must already be clamped by the caller
(frontend/orb.py); `check=True` verifies that on the host and raises.
"""

from __future__ import annotations

import torch

from droplet_visual_odometry_tpu_torch.ops import build

PATCH = 37  # patch side; supports rotated samples with radius <= 18

LAUNCHES = 0  # kernel launches made by extract_patches_cuda


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


def extract_patches_cuda(imgs: torch.Tensor, origins: torch.Tensor, check: bool = False) -> torch.Tensor:
    """(N, H, W) float32 + (M, 3) int32 clamped origins -> (M, 37, 37) float32.

    CUDA tensors run the hand-written kernel; CPU tensors run the plain twin.
    """
    if imgs.device.type == "cpu" and origins.device.type == "cpu":
        return extract_patches_plain(imgs, origins, check)
    if imgs.device.type != "cuda" or origins.device != imgs.device:
        raise ValueError(
            f"extract_patches_cuda: images on {imgs.device}, origins on {origins.device}"
        )
    if imgs.dtype != torch.float32 or imgs.dim() != 3 or not imgs.is_contiguous():
        raise ValueError(
            f"extract_patches_cuda: need contiguous (N, H, W) float32 images, got "
            f"{tuple(imgs.shape)} {imgs.dtype}"
        )
    if origins.dtype != torch.int32 or origins.dim() != 2 or origins.shape[1] != 3 or not origins.is_contiguous():
        raise ValueError(
            f"extract_patches_cuda: need contiguous (M, 3) int32 origins, got "
            f"{tuple(origins.shape)} {origins.dtype}"
        )
    n, h, w = imgs.shape
    if h < PATCH or w < PATCH:
        raise ValueError(f"extract_patches_cuda: images {h}x{w} smaller than the {PATCH}px patch")
    if check:
        _check_origins(origins, n, h, w)
    m = origins.shape[0]
    out = torch.empty((m, PATCH, PATCH), dtype=torch.float32, device=imgs.device)
    if m == 0:
        return out
    global LAUNCHES
    lib = build.library()
    status = lib.dvo_extract_patches(
        imgs.data_ptr(), origins.data_ptr(), out.data_ptr(), m, h, w,
        build.current_stream_ptr(imgs.device),
    )
    LAUNCHES += 1
    build.check(status, "dvo_extract_patches")
    return out
