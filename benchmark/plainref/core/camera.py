"""Camera model: pinhole intrinsics + plumb_bob distortion, and the undistortion
preprocessor — port of droplet_visual_odometry_tpu/core/camera.py.

The camera itself is host data (a numpy dataclass). The per-pixel parts
(`distort_normalized`, `undistort_points`, `undistort_rectify_map`,
`remap_bilinear`) are torch functions that run on the device of their input
tensors, in float32 like the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Camera:
    """Pinhole camera with plumb_bob (Brown-Conrady k1 k2 p1 p2 k3) distortion."""

    K: np.ndarray  # (3, 3) float32 intrinsic matrix
    dist: np.ndarray  # (5,) float32 [k1, k2, p1, p2, k3]
    width: int
    height: int

    @property
    def fx(self):
        return self.K[0, 0]

    @property
    def fy(self):
        return self.K[1, 1]

    @property
    def cx(self):
        return self.K[0, 2]

    @property
    def cy(self):
        return self.K[1, 2]


def make_camera(fx, fy, cx, cy, dist=None, width=1440, height=1080) -> Camera:
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], dtype=np.float32)
    d = np.zeros((5,), np.float32) if dist is None else np.asarray(dist, np.float32)
    return Camera(K=K, dist=d, width=int(width), height=int(height))


def load_calibration(path: str, controlled: bool = False) -> Camera:
    """Parse the robot (`controlled=False`) or lab (`controlled=True`)
    calibration YAML schema (reference: core/camera.py:load_calibration)."""
    import yaml  # only calibration files need it

    with open(path) as f:
        data: dict[str, Any] = yaml.safe_load(f)
    if not controlled:
        K = np.asarray(data["intrinsic_coeffs"][0], dtype=np.float32).reshape(3, 3)
        dist = np.asarray(data["distortion_coeffs"][0], dtype=np.float32).reshape(-1)
        width = int(data.get("image_width", 1440))
        height = int(data.get("image_height", 1080))
    else:
        K = np.asarray(data["camera_matrix"]["data"], dtype=np.float32).reshape(3, 3)
        dist = np.asarray(data["distortion_coefficients"]["data"], dtype=np.float32).reshape(-1)
        width = int(data.get("image_width", 640))
        height = int(data.get("image_height", 480))
    dist5 = np.zeros(5, np.float32)
    dist5[: min(5, dist.size)] = dist[:5]
    return Camera(K=K, dist=dist5, width=width, height=height)


def _coeffs(dist: torch.Tensor | np.ndarray, like: torch.Tensor) -> list[torch.Tensor]:
    d = torch.as_tensor(np.asarray(dist, np.float32), device=like.device)
    return list(d.unbind(0))


def distort_normalized(pts: torch.Tensor, dist) -> torch.Tensor:
    """Apply plumb_bob distortion to normalized image coords (..., 2)."""
    k1, k2, p1, p2, k3 = _coeffs(dist, pts)
    x, y = pts[..., 0], pts[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xy = x * y
    xd = x * radial + 2.0 * p1 * xy + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * xy
    return torch.stack([xd, yd], dim=-1)


def undistort_points(
    pts_px: torch.Tensor, cam: Camera, new_K: np.ndarray | None = None, iters: int = 8
) -> torch.Tensor:
    """Undistort pixel coords (..., 2) by fixed-point iteration
    (cv.undistortPoints equivalent); pixels under `new_K` (default cam.K)."""
    K = torch.as_tensor(cam.K, device=pts_px.device)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    dx0 = (pts_px[..., 0] - cx) / fx
    dy0 = (pts_px[..., 1] - cy) / fy
    k1, k2, p1, p2, k3 = _coeffs(cam.dist, pts_px)
    x, y = dx0, dy0
    for _ in range(iters):
        r2 = x * x + y * y
        icdist = 1.0 / (1.0 + r2 * (k1 + r2 * (k2 + r2 * k3)))
        ddx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        ddy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x, y = (dx0 - ddx) * icdist, (dy0 - ddy) * icdist
    out_K = K if new_K is None else torch.as_tensor(np.asarray(new_K, np.float32), device=pts_px.device)
    return torch.stack([x * out_K[0, 0] + out_K[0, 2], y * out_K[1, 1] + out_K[1, 2]], dim=-1)


def optimal_new_camera_matrix(cam: Camera, alpha: float = 1.0) -> np.ndarray:
    """Host-side cv.getOptimalNewCameraMatrix(alpha) for same-size output,
    from the undistorted positions of a 9x9 boundary grid (reference:
    core/camera.py:optimal_new_camera_matrix)."""
    w, h = cam.width, cam.height
    n = 9
    us = np.linspace(0, w - 1, n, dtype=np.float64)
    vs = np.linspace(0, h - 1, n, dtype=np.float64)
    grid = np.stack(np.meshgrid(us, vs), axis=-1).reshape(-1, 2).astype(np.float32)
    und = undistort_points(torch.from_numpy(grid), cam, new_K=np.eye(3, dtype=np.float32), iters=12)
    und = und.numpy().reshape(n, n, 2)

    x0o, y0o = und[..., 0].min(), und[..., 1].min()
    x1o, y1o = und[..., 0].max(), und[..., 1].max()
    x0i = und[:, :, 0].min(axis=1).max()
    x1i = und[:, :, 0].max(axis=1).min()
    y0i = und[:, :, 1].min(axis=0).max()
    y1i = und[:, :, 1].max(axis=0).min()

    def k_from_rect(x0, y0, x1, y1):
        fx = (w - 1) / max(x1 - x0, 1e-9)
        fy = (h - 1) / max(y1 - y0, 1e-9)
        return fx, fy, -fx * x0, -fy * y0

    fo = k_from_rect(x0o, y0o, x1o, y1o)
    fi = k_from_rect(x0i, y0i, x1i, y1i)
    a = float(np.clip(alpha, 0.0, 1.0))
    fx, fy, cx, cy = (fi[i] * (1 - a) + fo[i] * a for i in range(4))
    return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], dtype=np.float32)


def undistort_rectify_map(cam: Camera, new_K: np.ndarray, device="cpu") -> torch.Tensor:
    """(H, W, 2) distorted source location of every destination pixel under
    new_K (cv.initUndistortRectifyMap equivalent)."""
    h, w = cam.height, cam.width
    nK = torch.as_tensor(np.asarray(new_K, np.float32), device=device)
    K = torch.as_tensor(cam.K, device=device)
    u = torch.arange(w, dtype=torch.float32, device=device)
    v = torch.arange(h, dtype=torch.float32, device=device)
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    pn = torch.stack([(uu - nK[0, 2]) / nK[0, 0], (vv - nK[1, 2]) / nK[1, 1]], dim=-1)
    pd = distort_normalized(pn, cam.dist)
    return torch.stack([pd[..., 0] * K[0, 0] + K[0, 2], pd[..., 1] * K[1, 1] + K[1, 2]], dim=-1)


def remap_bilinear(img: torch.Tensor, src_map: torch.Tensor) -> torch.Tensor:
    """Bilinear sample (..., H, W) images at src_map (H', W', 2) -> (..., H', W')
    float32, border-clamped like the reference."""
    H, W = img.shape[-2], img.shape[-1]
    img = img.to(torch.float32)
    su = torch.clamp(src_map[..., 0], 0.0, W - 1.0)
    sv = torch.clamp(src_map[..., 1], 0.0, H - 1.0)
    u0 = torch.floor(su).to(torch.int64)
    v0 = torch.floor(sv).to(torch.int64)
    u1 = torch.clamp(u0 + 1, max=W - 1)
    v1 = torch.clamp(v0 + 1, max=H - 1)
    du = su - u0.to(torch.float32)
    dv = sv - v0.to(torch.float32)
    flat = img.reshape(img.shape[:-2] + (H * W,))

    def take(vi, ui):
        return flat[..., (vi * W + ui).reshape(-1)].reshape(img.shape[:-2] + vi.shape)

    top = take(v0, u0) * (1 - du) + take(v0, u1) * du
    bot = take(v1, u0) * (1 - du) + take(v1, u1) * du
    return top * (1 - dv) + bot * dv

