"""The windowed-BA backend, plain torch and numpy: the semantics of the
port's refine_trajectory (backend/refine.py), written apart from it.

keyframes -> one frontend pass over the keyframe stack and one
cross-checked match of its consecutive pairs -> windows of `window`
keyframes, each next window starting at the last two keyframes of the one
before (its two fixed poses) -> per window: tracks anchored at the
window's first keyframe (slot l is keypoint l there, chained forward
through the consecutive matches while they hold), multi-view DLT
triangulation, the reprojection filter, then LM (plainref/backend/ba.py)
when at least MIN_TRACKS tracks keep min_views views -> the trust gates
(the marker gate where the window's keyframes see the marker, else the
correction-magnitude gate) -> every frame re-anchored to its keyframe.

The geometry of a window (triangulation, the filter, LM) is float64, as
the port's (refine.BA_DTYPE there); the frontend and the match stay
float32. The control, one precision below, runs the windows in float32.

Departures from the port (none changes a result in exact arithmetic):

- tracks are chained on the host in numpy, window by window, from the
  matches read back once;
- each track's DLT is the 3x3 inhomogeneous normal equations of its
  observing views' rows (with the port's 1e-7 x trace Tikhonov term),
  solved by torch.linalg.solve, and only for tracks with min_views views
  (the rest are invalid in the port too), not by an unrolled Cholesky over
  every slot;
- the marker gate's error is worked out in float64 numpy from the corners.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from plainref.backend import ba, keyframes
from plainref.backend.refine import reanchor_segments
from plainref.frontend.features import detect_and_describe_batch
from plainref.frontend.matcher import match

MIN_TRACKS = 12  # tracks over min_views a window needs, else it is skipped
MATCH_MAX_DISTANCE = 80.0  # Hamming bits a track's continuation may differ by
MIN_DEPTH = 1e-3  # a landmark in front of every observing view by this much (m)


@dataclasses.dataclass(frozen=True)
class RefineConfig:
    """Same fields and defaults as the port's RefineConfig."""

    window: int = 8
    kf: keyframes.KeyframeConfig = keyframes.KeyframeConfig()
    ba: ba.BAConfig = ba.BAConfig(n_fixed=2)
    n_keypoints: int = 512
    fast_threshold: float = 20.0
    reproj_filter_px: float = 3.0
    min_views: int = 3
    marker_gate_tol_px: float = 0.5
    max_rot_correction_deg: float = 3.0
    max_trans_correction_frac: float = 0.5


def chain_tracks(xy: np.ndarray, valid0: np.ndarray, idx: np.ndarray, ok: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Keypoints xy (W, K, 2) of a window, the first keyframe's validity
    (K,), and the matches of its consecutive pairs (W-1, K) -> observations
    (W, K, 2) and mask (W, K) of the tracks anchored at keypoint l of the
    first keyframe. A dead track keeps pointing at keypoint 0, masked."""
    W, K = xy.shape[:2]
    at = np.arange(K)
    alive = valid0.copy()
    obs, mask = np.empty((W, K, 2), xy.dtype), np.empty((W, K), bool)
    obs[0], mask[0] = xy[0], alive
    for w in range(1, W):
        alive = alive & ok[w - 1][at]
        at = np.where(alive, idx[w - 1][at], 0)
        obs[w], mask[w] = xy[w][at], alive
    return obs, mask


def triangulate(obs: torch.Tensor, mask: torch.Tensor, poses: torch.Tensor, K: torch.Tensor,
                min_views: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Each track's point from its observing views (multi-view DLT with the
    point's last coordinate 1): ((K, 3) points, (K,) valid: min_views
    views, in front of every observing view, finite)."""
    views = mask.sum(0)
    tracks = torch.nonzero(views >= min_views)[:, 0]
    X = torch.zeros((mask.shape[1], 3), dtype=poses.dtype, device=poses.device)
    if len(tracks):
        m = mask[:, tracks].to(poses.dtype)  # (W, T)
        x = (obs[:, tracks, 0] - K[0, 2]) / K[0, 0]
        y = (obs[:, tracks, 1] - K[1, 2]) / K[1, 1]
        P = poses[:, :3, :]  # (W, 3, 4)
        rows = torch.cat([(x[..., None] * P[:, None, 2] - P[:, None, 0]) * m[..., None],
                          (y[..., None] * P[:, None, 2] - P[:, None, 1]) * m[..., None]], dim=0)  # (2W, T, 4)
        A = rows.transpose(0, 1)  # (T, 2W, 4)
        M, d = A[..., :3], A[..., 3:]
        N = M.transpose(-1, -2) @ M
        tr = N.diagonal(dim1=-2, dim2=-1).sum(-1)
        N = N + 1e-7 * tr[:, None, None] * torch.eye(3, dtype=N.dtype, device=N.device)
        X[tracks] = torch.linalg.solve(N, -(M.transpose(-1, -2) @ d))[..., 0]
    depth = ba.camera_points(poses, X)[..., 2]
    in_front = torch.all(~mask | (depth > MIN_DEPTH), dim=0)
    return X, (views >= min_views) & in_front & torch.all(torch.isfinite(X), dim=-1)


def reprojection_filter(obs, mask, X, poses, K, max_px: float, min_views: int) -> torch.Tensor:
    """The observations within max_px of their point's projection and in
    front of the camera, on tracks that keep min_views of them: (W, K)."""
    pc = ba.camera_points(poses, X)
    z = torch.clamp(pc[..., 2], min=1e-6)
    du = K[0, 0] * pc[..., 0] / z + K[0, 2] - obs[..., 0]
    dv = K[1, 1] * pc[..., 1] / z + K[1, 2] - obs[..., 1]
    keep = mask & (torch.sqrt(du * du + dv * dv) < max_px) & (pc[..., 2] > MIN_DEPTH)
    return keep & (keep.sum(0) >= min_views)[None]


def marker_error_px(poses: np.ndarray, K: np.ndarray, corners: np.ndarray, marker_length: float) -> float | None:
    """Mean pixel distance of the marker square's corners through cTm poses
    from their observed corners, over the poses that see all four; None
    without any."""
    s = float(np.float32(marker_length / 2.0))
    square = np.array([[-s, -s, 0.0], [s, -s, 0.0], [s, s, 0.0], [-s, s, 0.0]])
    errs = []
    for T, c in zip(np.asarray(poses, np.float64), np.asarray(corners, np.float64)):
        if np.all(np.isfinite(c)):
            p = square @ T[:3, :3].T + T[:3, 3]
            z = np.maximum(p[:, 2], 1e-6)
            uv = np.stack([K[0, 0] * p[:, 0] / z + K[0, 2], K[1, 1] * p[:, 1] / z + K[1, 2]], axis=1)
            errs.append(np.mean(np.linalg.norm(uv - c, axis=1)))
    return float(np.mean(errs)) if errs else None


def gate(new: np.ndarray, old: np.ndarray, cost_ok: bool, before: float | None, after: float | None,
         cfg: RefineConfig) -> bool:
    """Whether a window's poses are taken: with marker errors, when the cost
    fell and the marker error grew by no more than the tolerance; without,
    when the cost fell and no pose turned or moved too far."""
    if before is not None:
        return cost_ok and after <= before + cfg.marker_gate_tol_px
    cosang = (np.trace(np.einsum("wij,wkj->wik", new[:, :3, :3], old[:, :3, :3]), axis1=1, axis2=2) - 1) / 2
    rot = np.degrees(np.arccos(np.clip(cosang, -1, 1)))
    moved = np.linalg.norm(new[:, :3, 3] - old[:, :3, 3], axis=1)
    span = float(np.sum(np.linalg.norm(np.diff(old[:, :3, 3], axis=0), axis=1)))
    return (cost_ok and float(rot.max()) <= cfg.max_rot_correction_deg
            and float(moved.max()) <= cfg.max_trans_correction_frac * max(span, 1e-9))


def refine_trajectory(fetch, abs_poses: np.ndarray, n_inliers: np.ndarray, K, cfg: RefineConfig = RefineConfig(),
                      marker_corners: np.ndarray | None = None, marker_length: float | None = None,
                      dtype: torch.dtype = torch.float64) -> tuple[np.ndarray, dict]:
    """A VO trajectory (N, 4, 4) cTm smoothed by windowed BA; `fetch(idx)`
    gives the undistorted float frames of idx on the device; `dtype` is the
    windows' geometry's (float32 for the control). Returns the
    refined (N, 4, 4) poses and {"n_keyframes", "windows" (solved, not
    skipped), "accepted" (each solved window's gate)}."""
    abs_poses = np.asarray(abs_poses, np.float64)
    kf_idx = np.flatnonzero(keyframes.select_keyframes(abs_poses, np.asarray(n_inliers), cfg.kf))
    info = {"n_keyframes": len(kf_idx), "windows": 0, "accepted": []}
    if len(kf_idx) < 3:
        return abs_poses.copy(), info

    feats = detect_and_describe_batch(fetch(kf_idx), k=cfg.n_keypoints, threshold=cfg.fast_threshold)
    m = match(feats.desc[:-1], feats.desc[1:], feats.valid[:-1], feats.valid[1:], mode="crosscheck",
              max_distance=MATCH_MAX_DISTANCE)
    dev = feats.xy.device
    xy, valid = feats.xy.cpu().numpy(), feats.valid.cpu().numpy()
    m_idx, m_ok = m.idx.cpu().numpy(), m.valid.cpu().numpy()
    Kt = torch.as_tensor(np.asarray(K), dtype=dtype, device=dev)
    K64 = np.asarray(K, np.float64)
    corners = None if marker_corners is None else np.asarray(marker_corners, np.float64)[kf_idx]
    refined = abs_poses[kf_idx].copy()
    W = min(cfg.window, len(kf_idx))

    start = 0
    while start < len(kf_idx) - 2:
        sl = slice(start, min(start + W, len(kf_idx)))
        obs_np, mask_np = chain_tracks(xy[sl], valid[sl.start], m_idx[sl.start : sl.stop - 1],
                                       m_ok[sl.start : sl.stop - 1])
        obs = torch.as_tensor(obs_np, dtype=dtype, device=dev)
        mask = torch.as_tensor(mask_np, device=dev)
        poses0 = torch.as_tensor(refined[sl], dtype=dtype, device=dev)
        X, ok = triangulate(obs, mask, poses0, Kt, cfg.min_views)
        mask = reprojection_filter(obs, mask, X, poses0, Kt, cfg.reproj_filter_px, cfg.min_views) & ok[None]
        if int((mask.sum(0) >= cfg.min_views).sum()) < MIN_TRACKS:
            start += W - 2
            continue
        res = ba.run_ba(poses0, X, obs, mask, Kt, cfg.ba)
        new = res["poses"].cpu().numpy().astype(np.float64)
        old = refined[sl]
        cost_ok = res["final_cost"] <= res["initial_cost"] and np.isfinite(res["final_cost"])
        before = after = None
        if corners is not None and marker_length is not None:
            before = marker_error_px(old, K64, corners[sl], marker_length)
            after = marker_error_px(new, K64, corners[sl], marker_length)
        accept = gate(new, old, cost_ok, before, after, cfg)
        if accept:
            refined[sl] = new
        info["accepted"].append(accept)
        info["windows"] += 1
        start += max(W - 2, 1)
    return reanchor_segments(abs_poses, kf_idx, refined), info
