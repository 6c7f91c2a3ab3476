"""Multi-view feature tracks over a keyframe window — port of
droplet_visual_odometry_tpu/backend/tracks.py.

Tracks are anchored at the window's first keyframe: slot l holds keypoint l
of keyframe 0, chained forward through the matches of consecutive
keyframes, so a window of W keyframes and K keypoint slots gives a (W, K)
observation grid and mask. The matches of every consecutive pair of a
keyframe stack are one call of the match kernel (`match_consecutive`);
windows slice them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from droplet_visual_odometry_tpu_torch.frontend import matcher
from droplet_visual_odometry_tpu_torch.frontend.orb import Features
from droplet_visual_odometry_tpu_torch.ops import linalg


class TrackGrid(NamedTuple):
    obs_uv: torch.Tensor  # (W, K, 2) pixel observation of track l in keyframe w
    obs_mask: torch.Tensor  # (W, K) bool


def match_consecutive(features: Features, match_mode: str = "crosscheck", max_distance: float = 80.0) -> matcher.Matches:
    """Matches of keyframe w to w+1 for every w of a (W, K) feature stack:
    (W-1, K) fields, one launch of the match kernel. max_distance gates
    continuations on Hamming distance (a good match is well under 80 of
    256 bits)."""
    return matcher.match(features.desc[:-1], features.desc[1:], features.valid[:-1], features.valid[1:],
                         mode=match_mode, max_distance=max_distance)


def build_tracks(features: Features, matches: matcher.Matches) -> TrackGrid:
    """Chain the consecutive matches (W-1, K) through a (W, K) feature stack
    into the anchored (W, K) track grid."""
    W, K = features.xy.shape[:2]
    kp_idx = torch.arange(K, device=features.xy.device)  # keypoint of track l in the current keyframe
    alive = features.valid[0]
    obs, mask = [features.xy[0]], [alive]
    for w in range(1, W):
        # Track l (at kp_idx[l] in keyframe w-1) continues iff that keypoint matched.
        nxt = matches.idx[w - 1][kp_idx]
        ok = alive & matches.valid[w - 1][kp_idx]
        kp_idx = torch.where(ok, nxt, torch.zeros_like(nxt))
        alive = ok
        obs.append(features.xy[w][kp_idx])
        mask.append(alive)
    return TrackGrid(obs_uv=torch.stack(obs), obs_mask=torch.stack(mask))


def triangulate_tracks(
    grid: TrackGrid, poses_cTw: torch.Tensor, K: torch.Tensor, min_views: int = 2
) -> tuple[torch.Tensor, torch.Tensor]:
    """Landmarks from all observations of each track: multi-view DLT by the
    3x3 inhomogeneous normal equations, masked over views. Returns ((K, 3)
    world points, (K,) valid: enough views, positive depth in every
    observing view, finite)."""
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    x = (grid.obs_uv[..., 0] - cx) / fx
    y = (grid.obs_uv[..., 1] - cy) / fy
    P = poses_cTw[:, :3, :]  # (W, 3, 4) [R|t] rows
    # DLT rows: x*(P3 . X) - (P1 . X) = 0 etc., with X = [p; 1].
    r1 = x[..., None] * P[:, None, 2, :] - P[:, None, 0, :]  # (W, K, 4)
    r2 = y[..., None] * P[:, None, 2, :] - P[:, None, 1, :]
    m = grid.obs_mask[..., None].to(r1.dtype)
    A = torch.cat([r1 * m, r2 * m], dim=0).transpose(0, 1)  # (K, 2W, 4)
    M, d = A[..., :3], A[..., 3]
    MtM = torch.einsum("kni,knj->kij", M, M)
    Mtd = torch.einsum("kni,kn->ki", M, d)
    tr = (MtM[..., 0, 0] + MtM[..., 1, 1] + MtM[..., 2, 2])[..., None, None]
    eye = torch.eye(3, dtype=M.dtype, device=M.device)
    X = linalg.solve_spd(MtM + 1e-7 * tr * eye, -Mtd)

    views = torch.sum(grid.obs_mask, dim=0)
    p_cam = torch.einsum("wij,kj->wki", poses_cTw[:, :3, :3], X) + poses_cTw[:, None, :3, 3]
    depth_ok = torch.all(torch.where(grid.obs_mask, p_cam[..., 2] > 1e-3, True), dim=0)
    valid = (views >= min_views) & depth_ok & torch.all(torch.isfinite(X), dim=-1)
    return X, valid


def filter_by_reprojection(
    grid: TrackGrid, X: torch.Tensor, poses_cTw: torch.Tensor, K: torch.Tensor, max_err_px: float = 2.0,
    min_views: int = 2,
) -> TrackGrid:
    """Drop observations that reproject more than max_err_px from (X, poses)
    or lie behind the camera, then tracks left with fewer than min_views."""
    p = torch.einsum("wij,kj->wki", poses_cTw[:, :3, :3], X) + poses_cTw[:, None, :3, 3]
    z = torch.clamp(p[..., 2], min=1e-6)
    u = K[0, 0] * p[..., 0] / z + K[0, 2]
    v = K[1, 1] * p[..., 1] / z + K[1, 2]
    err = torch.linalg.vector_norm(torch.stack([u, v], -1) - grid.obs_uv, dim=-1)
    keep = grid.obs_mask & (err < max_err_px) & (p[..., 2] > 1e-3)
    keep = keep & (torch.sum(keep, dim=0) >= min_views)[None, :]
    return TrackGrid(obs_uv=grid.obs_uv, obs_mask=keep)
