"""SURF-mode frontend — port of droplet_visual_odometry_tpu/frontend/surf.py,
batched over frames.

Detector: the scale-normalised determinant of the Hessian,
(Lxx Lyy - (0.9 Lxy)^2) s^4 from central differences of f32 blurs at the
sigma ladder 1.2 / 2.0 / 3.2, the max over scales and 0; then the SIFT
frontend's interior mask, 3x3 NMS and flat top-k. Descriptor: 4x4 cells x
(sum dx, sum |dx|, sum dy, sum |dy|) = 64 of the rotated gradient samples
of the SIFT frontend's pre-rotated 16x16 grid, Gaussian-weighted, one f32
contraction with the static cell matrix, L2-normalised. Plain torch, as the
reference runs it in XLA; the octave loop is the SIFT frontend's.
"""

from __future__ import annotations

import torch

from droplet_visual_odometry_tpu_torch.frontend import filters
from droplet_visual_odometry_tpu_torch.frontend.fast import Keypoints
from droplet_visual_odometry_tpu_torch.frontend.orb import Features
from droplet_visual_odometry_tpu_torch.frontend.sift import (
    N_OCTAVES,
    _l2_normalise,
    _tables,
    detect_octaves,
    interior_topk,
    rotated_samples,
)

N_CELLS = 4
N_DIM = N_CELLS * N_CELLS * 4  # 64
SIGMAS = (1.2, 2.0, 3.2)


def hessian_response(img: torch.Tensor, sigmas=SIGMAS) -> torch.Tensor:
    """(..., H, W) -> scale-normalised det-of-Hessian response, the max over
    the sigma ladder, clamped at 0 (jnp.gradient's differences twice)."""
    img = img.to(torch.float32)
    best = None
    for s in sigmas:
        g = filters.gaussian_blur(img, sigma=s, radius=int(3 * s + 0.5))
        gy, gx = torch.gradient(g, dim=(-2, -1))
        gxy, gxx = torch.gradient(gx, dim=(-2, -1))
        gyy = torch.gradient(gy, dim=-2)[0]
        sxy = 0.9 * gxy
        det = (gxx * gyy - sxy * sxy) * (s**4)
        best = det if best is None else torch.maximum(best, det)
    return torch.clamp(best, min=0.0)


def detect_blobs(img: torch.Tensor, k: int = 512, threshold: float = 1.0) -> Keypoints:
    """(N, H, W) -> Hessian blobs: response, interior mask, NMS, top-k."""
    return interior_topk(hessian_response(img), k, threshold)


def describe(img_blur: torch.Tensor, kps: Keypoints) -> tuple[torch.Tensor, torch.Tensor]:
    """(N, H, W) blurred frames + (N, K) keypoints -> ((N, K, 64) float32
    descriptors, (N, K) angles)."""
    n, k = kps.xy.shape[0], kps.xy.shape[1]
    _, cell_onehot, spatial_w = _tables(img_blur.device)
    ang, c, s, sgy, sgx = rotated_samples(img_blur, kps)
    rgx = (c * sgx + s * sgy) * spatial_w
    rgy = (-s * sgx + c * sgy) * spatial_w
    chans = torch.stack([rgx, torch.abs(rgx), rgy, torch.abs(rgy)], dim=-1)  # (N, K, 256, 4)
    desc = torch.matmul(cell_onehot.T, chans).reshape(n, k, N_DIM)  # (N, K, 16, 4) cells x channels
    return _l2_normalise(desc), ang


def detect_and_describe(
    imgs: torch.Tensor, k: int = 512, threshold: float = 1.0, n_octaves: int = N_OCTAVES
) -> Features:
    """(N, H, W) frames -> SURF Features (desc (N, K, 64) float32), K = k
    over all octaves, coordinates in full-resolution pixels."""
    return detect_octaves(imgs, k, threshold, n_octaves, detect_blobs, describe)
