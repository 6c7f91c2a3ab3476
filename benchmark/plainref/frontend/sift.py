"""The SIFT-mode frontend, plain torch — a copy, op for op, of the port's
droplet_visual_odometry_tpu_torch/frontend/sift.py (itself the reference's
frontend/sift.py), computed in blocks of frames.

Detector: the |DoG| blob response (the max of two adjacent DoG scales of
three f32 blurs), interior mask and threshold, 3x3 NMS and a flat top-k.
Descriptor: 4x4 spatial cells x 8 orientation bins = 128 over a 16x16
sample grid pre-rotated into the keypoint's angle bin, Gaussian-weighted,
L2 / clip 0.2 / L2, the cell accumulation one f32 matmul. Three octaves of
a power-of-two pyramid, a static per-octave budget summing to k.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from plainref.frontend import filters
from plainref.frontend.fast import Keypoints, nms3x3
from plainref.frontend.features import level_budgets
from plainref.frontend.orb import Features, extract_patches
from plainref.ops.cuda_describe import ANGLE_BINS, HALF, PATCH
from plainref.utils.device import constant

BLOCK = 8  # frames a pass takes at once: a frame's patches at K = 8192 are about 50 MB
N_CELLS = 4
N_ORI = 8
N_DIM = N_CELLS * N_CELLS * N_ORI  # 128
GRID = 16  # 16x16 gradient samples a patch
SPACING = 2  # sample spacing in pixels
N_OCTAVES = 3


def _rotated_grid_indices() -> np.ndarray:
    """(ANGLE_BINS, GRID*GRID) flat patch indices of the rotated 16x16 sample grid."""
    coords = (np.arange(GRID) - (GRID - 1) / 2.0) * SPACING
    dy, dx = np.meshgrid(coords, coords, indexing="ij")
    out = np.empty((ANGLE_BINS, GRID * GRID), np.int32)
    for b in range(ANGLE_BINS):
        a = 2.0 * np.pi * b / ANGLE_BINS
        c, s = np.cos(a), np.sin(a)
        ry = np.clip(np.round(s * dx + c * dy).astype(np.int32), -HALF, HALF) + HALF
        rx = np.clip(np.round(c * dx - s * dy).astype(np.int32), -HALF, HALF) + HALF
        out[b] = (ry * PATCH + rx).reshape(-1)
    return out


def _cell_onehot() -> np.ndarray:
    """(GRID*GRID, 16) sample position -> its cell (4x4 cells of 4x4 samples)."""
    onehot = np.zeros((GRID * GRID, N_CELLS * N_CELLS), np.float32)
    for gy in range(GRID):
        for gx in range(GRID):
            onehot[gy * GRID + gx, (gy // 4) * N_CELLS + (gx // 4)] = 1.0
    return onehot


def _spatial_weight() -> np.ndarray:
    """(GRID*GRID,) Gaussian weight over the sample grid (sigma half the window)."""
    coords = (np.arange(GRID) - (GRID - 1) / 2.0) * SPACING
    dy, dx = np.meshgrid(coords, coords, indexing="ij")
    w = np.exp(-(dy * dy + dx * dx) / (2.0 * (GRID * SPACING / 2.0) ** 2))
    return w.reshape(-1).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return (torch.from_numpy(_rotated_grid_indices()).to(device=device, dtype=torch.int64),
            torch.from_numpy(_cell_onehot()).to(device), torch.from_numpy(_spatial_weight()).to(device))


def downsample2(img: torch.Tensor) -> torch.Tensor:
    """f32 sigma=1 radius-2 blur, then 2x decimation of (..., H, W)."""
    return filters.gaussian_blur(img, sigma=1.0, radius=2)[..., ::2, ::2]


def select_topk(score_map: torch.Tensor, k: int) -> Keypoints:
    """Flat top-k of (..., H, W) NMS'd maps, ties to the lower flat index (a
    stable descending sort)."""
    h, w = score_map.shape[-2], score_map.shape[-1]
    flat = score_map.reshape(score_map.shape[:-2] + (h * w,))
    vals, idx = torch.sort(flat, dim=-1, descending=True, stable=True)
    vals, idx = vals[..., :k], idx[..., :k]
    xy = torch.stack([(idx % w).to(torch.float32), (idx // w).to(torch.float32)], dim=-1)
    return Keypoints(xy=xy, score=vals, valid=vals > 0.0)


def orientation(patches: torch.Tensor) -> torch.Tensor:
    """(..., 37, 37) patches -> intensity-centroid angles atan2(m01, m10) over the centred disc."""
    d = constant(tuple(float(i - HALF) for i in range(PATCH)), torch.float32, patches.device)
    yy, xx = d[:, None], d[None, :]
    disc = (yy * yy + xx * xx) <= (HALF * HALF)
    m01 = torch.sum(patches * torch.where(disc, yy, 0.0), dim=(-2, -1))
    m10 = torch.sum(patches * torch.where(disc, xx, 0.0), dim=(-2, -1))
    return torch.atan2(m01, m10)


def dog_response(img: torch.Tensor, sigma: float = 1.6, k: float = 1.6) -> torch.Tensor:
    """|DoG| blob response: max over |G(k s) - G(s)| for s in {sigma, k sigma}."""
    img = img.to(torch.float32)
    g1 = filters.gaussian_blur(img, sigma=sigma, radius=int(3 * sigma + 0.5))
    g2 = filters.gaussian_blur(img, sigma=sigma * k, radius=int(3 * sigma * k + 0.5))
    g3 = filters.gaussian_blur(img, sigma=sigma * k * k, radius=int(3 * sigma * k * k + 0.5))
    return torch.maximum(torch.abs(g2 - g1), torch.abs(g3 - g2))


def detect_blobs(img: torch.Tensor, k: int, threshold: float) -> Keypoints:
    """Response outside the descriptor patch's border or at most `threshold`
    set to 0, then 3x3 NMS and the flat top-k."""
    resp = dog_response(img)
    h, w = resp.shape[-2], resp.shape[-1]
    yy = torch.arange(h, device=resp.device)[:, None]
    xx = torch.arange(w, device=resp.device)[None, :]
    inside = (yy >= HALF) & (yy < h - HALF) & (xx >= HALF) & (xx < w - HALF)
    resp = torch.where(inside & (resp > threshold), resp, torch.zeros_like(resp))
    return select_topk(nms3x3(resp), k)


def describe(img_blur: torch.Tensor, kps: Keypoints) -> tuple[torch.Tensor, torch.Tensor]:
    """(N, H, W) blurred frames + (N, K) keypoints -> ((N, K, 128) descriptors, (N, K) angles)."""
    n, k = kps.xy.shape[0], kps.xy.shape[1]
    grid_idx, cell_onehot, spatial_w = _tables(img_blur.device)
    patches = extract_patches(img_blur.to(torch.float32), kps.xy)
    ang = orientation(patches)
    two_pi = 2.0 * np.pi
    bin_idx = torch.remainder(torch.round(ang / torch.full_like(ang, two_pi) * ANGLE_BINS), ANGLE_BINS).to(torch.int64)
    flat_gy = torch.gradient(patches, dim=-2)[0].reshape(n, k, PATCH * PATCH)
    flat_gx = torch.gradient(patches, dim=-1)[0].reshape(n, k, PATCH * PATCH)
    sample_idx = grid_idx[bin_idx]
    sgy = torch.gather(flat_gy, -1, sample_idx)
    sgx = torch.gather(flat_gx, -1, sample_idx)
    a = (two_pi * bin_idx.to(torch.float32) / torch.full_like(ang, ANGLE_BINS))[..., None]
    c, s = torch.cos(a), torch.sin(a)
    rgx = c * sgx + s * sgy
    rgy = -s * sgx + c * sgy
    mag = torch.sqrt(rgx * rgx + rgy * rgy + 1e-12) * spatial_w
    theta = torch.atan2(rgy, rgx)
    obin = torch.remainder(torch.floor((theta + np.pi) / torch.full_like(theta, 2.0 * np.pi / N_ORI)), N_ORI)
    ori_onehot = (obin.to(torch.int64)[..., None] == torch.arange(N_ORI, device=obin.device)).to(torch.float32)
    desc = torch.matmul(cell_onehot.T, mag[..., None] * ori_onehot).reshape(n, k, N_DIM)
    norm = lambda d: d / (torch.linalg.vector_norm(d, dim=-1, keepdim=True) + 1e-8)
    return norm(torch.clamp(norm(desc), max=0.2)), ang


def octave_count(h: int, w: int, n_octaves: int) -> int:
    """Octaves kept so that every octave is at least 64 px a side."""
    while n_octaves > 1 and min(h, w) // 2 ** (n_octaves - 1) < 64:
        n_octaves -= 1
    return n_octaves


def detect_and_describe(imgs: torch.Tensor, k: int = 512, threshold: float = 1.0,
                        n_octaves: int = N_OCTAVES) -> Features:
    """(N, H, W) frames -> SIFT-mode Features (desc (N, K, 128) float32), K
    = k over all octaves, coordinates in full-resolution pixels; BLOCK
    frames at a time (each frame's features are its own)."""
    if imgs.shape[0] > BLOCK:
        parts = [detect_and_describe(imgs[i:i + BLOCK], k, threshold, n_octaves)
                 for i in range(0, imgs.shape[0], BLOCK)]
        return Features(*(torch.cat(xs, dim=0) for xs in zip(*parts)))
    imgs = imgs.to(torch.float32)
    h0, w0 = imgs.shape[-2], imgs.shape[-1]
    n_octaves = octave_count(h0, w0, n_octaves)
    budgets = level_budgets(k, n_octaves, 2.0) if n_octaves > 1 else [k]
    parts = []
    oct_img = imgs
    for o in range(n_octaves):
        if o > 0:
            oct_img = downsample2(oct_img)
        lh, lw = oct_img.shape[-2], oct_img.shape[-1]
        kps = detect_blobs(oct_img, budgets[o], threshold)
        desc, ang = describe(filters.gaussian_blur(oct_img, sigma=2.0, radius=4), kps)
        x, y = kps.xy[..., 0], kps.xy[..., 1]
        interior = (x >= HALF) & (x < lw - HALF) & (y >= HALF) & (y < lh - HALF)
        parts.append(Features(xy=kps.xy * float(2**o), score=kps.score, angle=ang, desc=desc,
                              valid=kps.valid & interior))
    if n_octaves == 1:
        return parts[0]
    return Features(*(torch.cat(xs, dim=1) for xs in zip(*parts)))
