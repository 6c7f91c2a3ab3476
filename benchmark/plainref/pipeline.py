"""The reference's entry points: the same semantics as the port's
run_experiment (VO in memory or streamed in chunks, anchored at the first
marker frame, then the pose-graph backend) and OnlineVO's push step, op by
op on any device."""

from __future__ import annotations

import numpy as np
import torch

from plainref.backend.refine import PoseGraphRefineConfig, pose_graph_trajectory
from plainref.core import camera as camera_mod
from plainref.estimation.vo import VOConfig, VOTrajectory, two_frame_vo
from plainref.estimation.vo import run_sequence_eager as run_sequence
from plainref.frontend.features import detect_and_describe_batch
from plainref.utils import threefry
from plainref.utils.checkpoint import run_sequence_checkpointed


def make_preprocessor(camera: camera_mod.Camera, device):
    """Raw (C, H, W) uint8 frames (a host array or a tensor) -> float32
    undistorted frames on device."""
    to_dev = lambda c: (c if isinstance(c, torch.Tensor) else torch.as_tensor(np.asarray(c))).to(device)
    if not np.any(camera.dist):
        return lambda chunk: to_dev(chunk).to(torch.float32)
    new_K = camera_mod.optimal_new_camera_matrix(camera, alpha=1.0)
    src_map = camera_mod.undistort_rectify_map(camera, new_K, device=device)
    return lambda chunk: camera_mod.remap_bilinear(to_dev(chunk), src_map)


def effective_K(camera: camera_mod.Camera) -> np.ndarray:
    if not np.any(camera.dist):
        return np.asarray(camera.K)
    return camera_mod.optimal_new_camera_matrix(camera, alpha=1.0)


def effective_marker_corners(corners: np.ndarray, camera: camera_mod.Camera, new_K: np.ndarray) -> np.ndarray:
    corners = np.asarray(corners, np.float32)
    if not np.any(camera.dist):
        return corners
    und = camera_mod.undistort_points(torch.from_numpy(np.nan_to_num(corners)), camera, new_K=new_K)
    return np.where(np.isnan(corners), np.nan, und.numpy().astype(np.float32))


def run_vo(frames: np.ndarray, corners: np.ndarray, present: np.ndarray, marker_poses: np.ndarray,
           camera: camera_mod.Camera, marker_length: float, cfg: VOConfig, seed: int, device,
           stream: bool, chunk: int = 256) -> tuple[VOTrajectory, np.ndarray, np.ndarray, np.ndarray]:
    """VO over raw uint8 frames as run_experiment runs it: (trajectory as
    numpy arrays, anchored absolute poses (N, 4, 4) float64, effective K,
    effective corners)."""
    preprocess = make_preprocessor(camera, device)
    K = effective_K(camera).astype(np.float32)
    eff = effective_marker_corners(corners, camera, K)
    first = int(np.argmax(present)) if present.any() else 0
    init_pose = np.asarray(marker_poses[first], np.float32)
    key = threefry.prng_key(seed, device)
    if stream:
        traj = run_sequence_checkpointed(frames, eff, present, init_pose, K, marker_length, cfg, path=None,
                                         chunk=chunk, preprocess=preprocess, device=device, key=key)
    else:
        out = run_sequence(preprocess(frames), eff, present, init_pose, K, marker_length, cfg, key=key)
        traj = VOTrajectory(*(t.cpu().numpy() for t in out))
    vo_abs = np.asarray(traj.abs_poses, np.float64)
    if first > 0:
        vo_abs = vo_abs @ (np.linalg.inv(vo_abs[first]) @ np.asarray(init_pose, np.float64))
    return traj, vo_abs, K, eff


def run_pose_graph(frames: np.ndarray, vo_abs: np.ndarray, n_inliers: np.ndarray, scale_ok: np.ndarray,
                   corners: np.ndarray, present: np.ndarray, camera: camera_mod.Camera, marker_length: float,
                   cfg: VOConfig, device) -> np.ndarray:
    """The pose-graph backend over a VO trajectory, its keyframes fetched
    from the raw frames and undistorted here: refined (N, 4, 4) poses."""
    preprocess = make_preprocessor(camera, device)
    K = effective_K(camera).astype(np.float32)
    eff = effective_marker_corners(corners, camera, K)
    refined, _ = pose_graph_trajectory(
        lambda idx: preprocess(frames[np.asarray(idx)]), vo_abs, n_inliers, eff, present, K, marker_length,
        cfg, PoseGraphRefineConfig(), pair_scale_ok=scale_ok,
    )
    return refined


def push_steps(frames: np.ndarray, prev_idx: np.ndarray, curr_idx: np.ndarray, steps: np.ndarray,
               prev_corners: np.ndarray, curr_corners: np.ndarray, marker_valid: np.ndarray, K: np.ndarray,
               marker_length: float, cfg: VOConfig, seed: int, device) -> dict[str, np.ndarray]:
    """OnlineVO's armed push step for P pushes, each as the engine runs it:
    each frame detected and described alone (with the pyramid defaults, as
    the engine does), one pair at a time with its marker corners and flag
    and the draws of fold_in(PRNGKey(seed), step). Returns rel (P, 4, 4),
    n_matches, n_inliers and ok."""
    feats = {}
    for f in np.unique(np.concatenate([prev_idx, curr_idx])):
        feats[int(f)] = detect_and_describe_batch(
            torch.as_tensor(frames[int(f)][None], device=device).to(torch.float32), k=cfg.n_keypoints,
            threshold=cfg.fast_threshold, arc_length=cfg.fast_arc_length, mode=cfg.frontend,
            dog_threshold=cfg.dog_threshold)
    key = threefry.prng_key(seed, device)
    u_hyp, u_lo = threefry.ransac_uniforms(
        threefry.fold_in(key, torch.as_tensor(steps, dtype=torch.int64, device=device)), cfg.ransac)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    Kt = f32(K)
    out = {k: [] for k in ("rel", "n_matches", "n_inliers", "ok")}
    for p in range(len(steps)):
        res = two_frame_vo(
            feats[int(prev_idx[p])], feats[int(curr_idx[p])], f32(prev_corners[p])[None], f32(curr_corners[p])[None],
            torch.as_tensor(bool(marker_valid[p]), device=device).reshape(1), Kt, marker_length, cfg,
            u_hyp=u_hyp[p:p + 1], u_lo=None if u_lo is None else u_lo[p:p + 1],
        )
        for k in out:
            out[k].append(getattr(res, k)[0].cpu().numpy())
    return {k: np.stack(v) for k, v in out.items()}
