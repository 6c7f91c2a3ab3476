"""Float-descriptor (SIFT-mode) frontend — port of
droplet_visual_odometry_tpu/frontend/sift.py, batched over frames.

Detector: the |DoG| blob response (the max of two adjacent DoG scales of
three f32 blurs), interior mask and threshold, 3x3 NMS and a flat top-k.
Descriptor: 4x4 spatial cells x 8 orientation bins = 128 over a 16x16
sample grid pre-rotated into the keypoint's angle bin (the binary
frontend's steering trick), Gaussian-weighted, L2 / clip 0.2 / L2. The
cell accumulation is the reference's one-hot contraction, at f32. Every
stage is plain torch: the reference runs this frontend in XLA, outside any
Pallas kernel.

The reference vmaps one frame at a time; here every function takes a
leading batch of N frames, which changes no keypoint (each frame's
reductions stay within the frame).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from droplet_visual_odometry_tpu_torch.frontend import filters
from droplet_visual_odometry_tpu_torch.frontend.fast import Keypoints, nms3x3, select_topk
from droplet_visual_odometry_tpu_torch.frontend.orb import (
    ANGLE_BINS,
    HALF,
    PATCH,
    Features,
    extract_patches,
    orientation,
)

N_CELLS = 4  # 4x4 spatial grid
N_ORI = 8  # orientation bins
N_DIM = N_CELLS * N_CELLS * N_ORI  # 128
GRID = 16  # 16x16 gradient samples per patch
SPACING = 2  # sample spacing in pixels (covers 32 px, inside the 37 px patch)
N_OCTAVES = 3


def _rotated_grid_indices() -> np.ndarray:
    """(ANGLE_BINS, GRID*GRID) flat patch indices of the rotated 16x16 sample grid."""
    coords = (np.arange(GRID) - (GRID - 1) / 2.0) * SPACING
    dy, dx = np.meshgrid(coords, coords, indexing="ij")
    out = np.empty((ANGLE_BINS, GRID * GRID), np.int32)
    for b in range(ANGLE_BINS):
        a = 2.0 * np.pi * b / ANGLE_BINS
        c, s = np.cos(a), np.sin(a)
        ry = np.round(s * dx + c * dy).astype(np.int32)
        rx = np.round(c * dx - s * dy).astype(np.int32)
        ry = np.clip(ry, -HALF, HALF) + HALF
        rx = np.clip(rx, -HALF, HALF) + HALF
        out[b] = (ry * PATCH + rx).reshape(-1)
    return out


def _cell_onehot() -> np.ndarray:
    """(GRID*GRID, 16) static position -> cell assignment (4x4 cells of 4x4 samples)."""
    onehot = np.zeros((GRID * GRID, N_CELLS * N_CELLS), np.float32)
    for gy in range(GRID):
        for gx in range(GRID):
            onehot[gy * GRID + gx, (gy // 4) * N_CELLS + (gx // 4)] = 1.0
    return onehot


def _spatial_weight() -> np.ndarray:
    """(GRID*GRID,) Gaussian weight over the sample grid (sigma = half the window)."""
    coords = (np.arange(GRID) - (GRID - 1) / 2.0) * SPACING
    dy, dx = np.meshgrid(coords, coords, indexing="ij")
    w = np.exp(-(dy * dy + dx * dx) / (2.0 * (GRID * SPACING / 2.0) ** 2))
    return w.reshape(-1).astype(np.float32)


_GRID_INDICES = _rotated_grid_indices()
_CELL_ONEHOT = _cell_onehot()
_SPATIAL_W = _spatial_weight()


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(grid indices int64, cell one-hot, spatial weight) on `device`, built once."""
    return (
        torch.from_numpy(_GRID_INDICES).to(device=device, dtype=torch.int64),
        torch.from_numpy(_CELL_ONEHOT).to(device),
        torch.from_numpy(_SPATIAL_W).to(device),
    )


def dog_response(img: torch.Tensor, sigma: float = 1.6, k: float = 1.6) -> torch.Tensor:
    """(..., H, W) -> |DoG| blob response: max over |G(k s) - G(s)| for s in
    {sigma, k sigma}, three f32 blurs at radius int(3 s + 0.5)."""
    img = img.to(torch.float32)
    g1 = filters.gaussian_blur(img, sigma=sigma, radius=int(3 * sigma + 0.5))
    g2 = filters.gaussian_blur(img, sigma=sigma * k, radius=int(3 * sigma * k + 0.5))
    g3 = filters.gaussian_blur(img, sigma=sigma * k * k, radius=int(3 * sigma * k * k + 0.5))
    return torch.maximum(torch.abs(g2 - g1), torch.abs(g3 - g2))


def interior_topk(resp: torch.Tensor, k: int, threshold: float) -> Keypoints:
    """Responses outside the descriptor-patch border or at most `threshold`
    set to 0, then 3x3 NMS and the flat top-k (shared with the SURF frontend)."""
    h, w = resp.shape[-2], resp.shape[-1]
    yy = torch.arange(h, device=resp.device)[:, None]
    xx = torch.arange(w, device=resp.device)[None, :]
    inside = (yy >= HALF) & (yy < h - HALF) & (xx >= HALF) & (xx < w - HALF)
    resp = torch.where(inside & (resp > threshold), resp, torch.zeros_like(resp))
    return select_topk(nms3x3(resp), k)


def detect_blobs(img: torch.Tensor, k: int = 512, threshold: float = 1.0) -> Keypoints:
    """(N, H, W) -> DoG blobs: response, interior mask, NMS, top-k."""
    return interior_topk(dog_response(img), k, threshold)


def rotated_samples(img_blur: torch.Tensor, kps: Keypoints) -> tuple[torch.Tensor, ...]:
    """The part of describe shared with the SURF frontend: patches at the
    keypoints, their angles, the angle bins, and the patch gradients sampled
    on the bin's rotated grid. Returns (angle (N, K), cos and sin of the bin
    angle (N, K, 1), sampled d/dy and d/dx (N, K, 256))."""
    n, k = kps.xy.shape[0], kps.xy.shape[1]
    grid_idx, _, _ = _tables(img_blur.device)
    patches = extract_patches(img_blur.to(torch.float32), kps.xy)  # (N, K, P, P)
    ang = orientation(patches)
    two_pi = 2.0 * np.pi
    # Divide by tensors: on CUDA a division by a Python scalar becomes a
    # multiply by its reciprocal, which rounds differently from the reference.
    bin_idx = torch.remainder(
        torch.round(ang / torch.full_like(ang, two_pi) * ANGLE_BINS), ANGLE_BINS
    ).to(torch.int64)
    flat_gy = torch.gradient(patches, dim=-2)[0].reshape(n, k, PATCH * PATCH)
    flat_gx = torch.gradient(patches, dim=-1)[0].reshape(n, k, PATCH * PATCH)
    sample_idx = grid_idx[bin_idx]  # (N, K, 256)
    sgy = torch.gather(flat_gy, -1, sample_idx)
    sgx = torch.gather(flat_gx, -1, sample_idx)
    a = (two_pi * bin_idx.to(torch.float32) / torch.full_like(ang, ANGLE_BINS))[..., None]
    return ang, torch.cos(a), torch.sin(a), sgy, sgx


def _l2_normalise(d: torch.Tensor) -> torch.Tensor:
    return d / (torch.linalg.vector_norm(d, dim=-1, keepdim=True) + 1e-8)


def describe(img_blur: torch.Tensor, kps: Keypoints) -> tuple[torch.Tensor, torch.Tensor]:
    """(N, H, W) blurred frames + (N, K) keypoints -> ((N, K, 128) float32
    descriptors, (N, K) angles)."""
    n, k = kps.xy.shape[0], kps.xy.shape[1]
    _, cell_onehot, spatial_w = _tables(img_blur.device)
    ang, c, s, sgy, sgx = rotated_samples(img_blur, kps)
    rgx = c * sgx + s * sgy
    rgy = -s * sgx + c * sgy
    mag = torch.sqrt(rgx * rgx + rgy * rgy + 1e-12) * spatial_w
    theta = torch.atan2(rgy, rgx)  # (-pi, pi]
    obin = torch.remainder(
        torch.floor((theta + np.pi) / torch.full_like(theta, 2.0 * np.pi / N_ORI)), N_ORI
    ).to(torch.int64)
    # A comparison, not F.one_hot, which reads its input's range back to the host.
    ori_onehot = (obin[..., None] == torch.arange(N_ORI, device=obin.device)).to(torch.float32)  # (N, K, 256, 8)
    # positions -> cells (static) x positions -> orientations: one f32 matmul.
    desc = torch.matmul(cell_onehot.T, mag[..., None] * ori_onehot).reshape(n, k, N_DIM)
    desc = torch.clamp(_l2_normalise(desc), max=0.2)
    return _l2_normalise(desc), ang


def octave_count(h: int, w: int, n_octaves: int) -> int:
    """Octaves kept so that every octave is at least 64 px per axis."""
    while n_octaves > 1 and min(h, w) // 2 ** (n_octaves - 1) < 64:
        n_octaves -= 1
    return n_octaves


def detect_octaves(imgs: torch.Tensor, k: int, threshold: float, n_octaves: int, detect, describe_fn) -> Features:
    """The octave loop shared by the SIFT and SURF frontends: a power-of-two
    pyramid (downsample2), a static per-octave budget summing to k, detect
    and describe at each octave's resolution, coordinates times 2^o."""
    from droplet_visual_odometry_tpu_torch.frontend.features import level_budgets

    imgs = imgs.to(torch.float32)
    h0, w0 = imgs.shape[-2], imgs.shape[-1]
    n_octaves = octave_count(h0, w0, n_octaves)
    budgets = level_budgets(k, n_octaves, 2.0) if n_octaves > 1 else [k]
    parts = []
    oct_img = imgs
    for o in range(n_octaves):
        if o > 0:
            oct_img = filters.downsample2(oct_img)
        lh, lw = oct_img.shape[-2], oct_img.shape[-1]
        kps = detect(oct_img, k=budgets[o], threshold=threshold)
        blur = filters.gaussian_blur(oct_img, sigma=2.0, radius=4)
        desc, ang = describe_fn(blur, kps)
        x, y = kps.xy[..., 0], kps.xy[..., 1]
        interior = (x >= HALF) & (x < lw - HALF) & (y >= HALF) & (y < lh - HALF)
        parts.append(Features(xy=kps.xy * float(2**o), score=kps.score, angle=ang, desc=desc,
                              valid=kps.valid & interior))
    if n_octaves == 1:
        return parts[0]
    return Features(*(torch.cat(xs, dim=1) for xs in zip(*parts)))


def detect_and_describe(
    imgs: torch.Tensor, k: int = 512, threshold: float = 1.0, n_octaves: int = N_OCTAVES
) -> Features:
    """(N, H, W) frames -> SIFT-mode Features (desc (N, K, 128) float32),
    K = k over all octaves, coordinates in full-resolution pixels."""
    return detect_octaves(imgs, k, threshold, n_octaves, detect_blobs, describe)
