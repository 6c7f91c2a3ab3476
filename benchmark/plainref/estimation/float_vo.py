"""Per-pair VO with the SIFT frontend, plain torch: the program's
run_sequence body for `frontend="sift"` (estimation/vo.py), worked out
again from the raw frames.

The frontend is plainref/frontend/sift.py, in blocks of frames. The pairs
go through `two_frame_vo` below: plainref.estimation.vo.two_frame_vo with
its match (the plain L2 match over each pair's whole (K, K) matrix and a
stable sort) in blocks of PAIR_BLOCK pairs, and everything after the match
over all pairs at once, as the program batches them: on the card the sums
over a pair's points in LO-RANSAC (`torch.sum` in the Hartley
normalisation, the `bmm` of the Sampson error and of the polish's normal
matrix) take their order from the batch's shape, and on this scene the
same pair solved in a batch of 4 parts from itself solved in a batch of
143 by up to half a degree, as far as the TF32 control. Each pair draws from its own key of
split(PRNGKey(seed), N-1), as in the program. Then the 'hold' scale fill
and the pose chain. TF32 stays off for every matmul and convolution (set
at import); the benchmark's control turns it on around a call.
"""

from __future__ import annotations

import numpy as np
import torch

from plainref import pipeline
from plainref.core import se3
from plainref.estimation import scale as scale_mod
from plainref.estimation.ransac import ransac_pose
from plainref.estimation.vo import VOConfig, VOStepResult, VOTrajectory, chain_poses, hold_fill
from plainref.frontend import matcher, sift
from plainref.frontend.orb import Features
from plainref.utils import threefry

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

PAIR_BLOCK = 4  # pairs matched at once: at K = 8192 a pair's matrix, its masked copies and its sort take ~2 GB


def match_in_blocks(prev: Features, curr: Features, cfg: VOConfig) -> matcher.Matches:
    """plainref.frontend.matcher.match over the pairs, PAIR_BLOCK at a time."""
    parts = []
    for s in range(0, prev.desc.shape[0], PAIR_BLOCK):
        m = matcher.match(prev.desc[s:s + PAIR_BLOCK], curr.desc[s:s + PAIR_BLOCK], prev.valid[s:s + PAIR_BLOCK],
                          curr.valid[s:s + PAIR_BLOCK], mode=cfg.match_mode, ratio=cfg.ratio)
        parts.append(tuple(t.clone() for t in m))  # the index is a view of the block's whole sort: keep a copy
    return matcher.Matches(*(torch.cat(x) for x in zip(*parts)))


def two_frame_vo(prev: Features, curr: Features, prev_corners: torch.Tensor, curr_corners: torch.Tensor,
                 marker_valid: torch.Tensor, K: torch.Tensor, real_marker_length: float, cfg: VOConfig,
                 keys: torch.Tensor) -> VOStepResult:
    """plainref.estimation.vo.two_frame_vo, op for op, with the match in
    blocks of pairs: match, LO-RANSAC + pose, marker scale, over all P pairs."""
    m = match_in_blocks(prev, curr, cfg)
    p_prev, p_curr, valid = matcher.gather_correspondences(prev.xy, curr.xy, m)
    n_matches = torch.sum(valid, dim=-1).to(torch.int32)
    R, t_unit, res = ransac_pose(p_prev, p_curr, valid, K, cfg.ransac, None, None, keys)
    s, s_ok = scale_mod.scale_factor_with_valid(
        K, R, t_unit, prev_corners, curr_corners, real_marker_length, marker_valid,
        side=cfg.scale_side, estimator=cfg.scale_estimator,
    )
    rel = se3.make_se3(R, t_unit * s[:, None])
    rel_unit = se3.make_se3(R, t_unit)
    ok = (n_matches >= cfg.min_matches) & (res.n_inliers >= cfg.ransac.sample_size)
    eye = torch.eye(4, dtype=rel.dtype, device=rel.device)
    return VOStepResult(
        rel=torch.where(ok[:, None, None], rel, eye),
        rel_unit=torch.where(ok[:, None, None], rel_unit, eye),
        n_matches=n_matches,
        n_inliers=res.n_inliers,
        scale=s,
        scale_ok=s_ok & ok,
        ok=ok,
    )


def run_sequence(frames: torch.Tensor, corners: torch.Tensor, present: torch.Tensor, init_pose: torch.Tensor,
                 K: torch.Tensor, real_marker_length: float, cfg: VOConfig, key: torch.Tensor) -> VOTrajectory:
    """(N, H, W) float32 undistorted frames, (N, 4, 2) marker corners (NaN
    where absent), (N,) presence, the (4, 4) first pose, (3, 3) K and the
    run key, all on one device -> the trajectory, as the program's
    run_sequence gives it with init_scale 1."""
    if cfg.frontend != "sift":
        raise ValueError(f"float_vo runs the SIFT frontend, not {cfg.frontend!r}")
    if cfg.scale_mode not in ("marker", "hold"):
        raise ValueError(f"unknown scale_mode: {cfg.scale_mode}")
    n = frames.shape[0]
    keys = threefry.split(key, n - 1)
    corners = torch.nan_to_num(corners)
    feats = sift.detect_and_describe(frames, k=cfg.n_keypoints, threshold=cfg.dog_threshold)
    res = two_frame_vo(Features(*(a[:-1] for a in feats)), Features(*(a[1:] for a in feats)), corners[:-1],
                       corners[1:], present[:-1] & present[1:], K, real_marker_length, cfg, keys)
    if cfg.scale_mode == "hold":
        scales = hold_fill(res.scale, res.scale_ok, torch.ones((), dtype=torch.float32, device=frames.device))
        rels = res.rel_unit.clone()
        rels[:, :3, 3] = rels[:, :3, 3] * scales[:, None]
    else:
        scales, rels = res.scale, res.rel
    return VOTrajectory(abs_poses=chain_poses(init_pose, rels), rel_poses=rels, n_matches=res.n_matches,
                        n_inliers=res.n_inliers, scales=scales, scale_ok=res.scale_ok, ok=res.ok)


def run_vo(frames: np.ndarray, corners: np.ndarray, present: np.ndarray, marker_poses: np.ndarray, camera,
           marker_length: float, cfg: VOConfig, seed: int, device) -> tuple[VOTrajectory, np.ndarray]:
    """VO over raw uint8 frames as run_experiment(backend="none") runs it in
    memory: (the trajectory as numpy arrays, the poses anchored at the
    first marker frame, (N, 4, 4) float64)."""
    preprocess = pipeline.make_preprocessor(camera, device)
    K = pipeline.effective_K(camera).astype(np.float32)
    eff = pipeline.effective_marker_corners(corners, camera, K)
    first = int(np.argmax(present)) if present.any() else 0
    init_pose = np.asarray(marker_poses[first], np.float32)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    out = run_sequence(preprocess(frames), f32(eff), torch.as_tensor(np.asarray(present, bool), device=device),
                       f32(init_pose), f32(K), marker_length, cfg, threefry.prng_key(seed, device))
    traj = VOTrajectory(*(t.cpu().numpy() for t in out))
    vo_abs = np.asarray(traj.abs_poses, np.float64)
    if first > 0:
        vo_abs = vo_abs @ (np.linalg.inv(vo_abs[first]) @ np.asarray(init_pose, np.float64))
    return traj, vo_abs


def descriptor_pairs(frames: np.ndarray, camera, cfg: VOConfig, device) -> tuple[torch.Tensor, ...]:
    """The consecutive pairs' SIFT sets of raw uint8 frames, as one VO
    program matches them: (desc_a, desc_b, valid_a, valid_b), contiguous."""
    feats = sift.detect_and_describe(pipeline.make_preprocessor(camera, device)(frames), k=cfg.n_keypoints,
                                     threshold=cfg.dog_threshold)
    return tuple(t.contiguous() for t in (feats.desc[:-1], feats.desc[1:], feats.valid[:-1], feats.valid[1:]))
