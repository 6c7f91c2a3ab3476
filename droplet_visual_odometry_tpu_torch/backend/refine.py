"""Trajectory refinement over a VO run — port of the pose-graph half of
droplet_visual_odometry_tpu/backend/refine.py: keyframes -> loop-closure
retrieval and verification -> pose-graph optimisation -> trajectory
correction. Host orchestration in numpy, device work on the frames' device.

The windowed-BA half (RefineConfig, refine_trajectory) is ROADMAP A10.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from droplet_visual_odometry_tpu_torch.backend import keyframes, loop_closure, pose_graph
from droplet_visual_odometry_tpu_torch.frontend.features import detect_and_describe_batch


def _frame_fetcher(frames):
    """Accepts either an (N, H, W) tensor or a callable idx -> frames."""
    if callable(frames):
        return frames
    return lambda idx: frames[torch.as_tensor(np.asarray(idx), dtype=torch.int64, device=frames.device)]


def reanchor_segments(abs_poses: np.ndarray, kf_idx: np.ndarray, refined_kf: np.ndarray) -> np.ndarray:
    """Propagate keyframe corrections to in-between frames:
    abs_i <- abs_i @ inv(abs_kf_old) @ abs_kf_new for i in each keyframe's
    trailing segment (rigid attachment of the segment to its keyframe)."""
    refined = np.asarray(abs_poses, np.float64).copy()
    refined[kf_idx] = refined_kf
    for s in range(len(kf_idx)):
        k0 = kf_idx[s]
        k1 = kf_idx[s + 1] if s + 1 < len(kf_idx) else len(abs_poses)
        corr = np.linalg.inv(abs_poses[k0]) @ refined_kf[s]
        for i in range(k0 + 1, k1):
            refined[i] = abs_poses[i] @ corr
    return refined


@dataclasses.dataclass(frozen=True)
class PoseGraphRefineConfig:
    """Same fields and defaults as the reference's PoseGraphRefineConfig (see its comments)."""

    kf: keyframes.KeyframeConfig = keyframes.KeyframeConfig()
    lc: loop_closure.LoopClosureConfig = loop_closure.LoopClosureConfig()
    pg: pose_graph.PoseGraphConfig = pose_graph.PoseGraphConfig(iters=15)
    n_keypoints: int = 1024
    fast_threshold: float = 20.0
    seq_weight_live: float = 1.0
    seq_weight_held: float = 0.05
    loop_rot_weight_scale_free: float = 1.0
    loop_dir_weight_scale_free: float = 0.5
    edge_rot_disp_deg0: float = 2.0
    edge_dir_disp_deg0: float = 5.0


def keyframe_indices(abs_poses: np.ndarray, n_inliers: np.ndarray, marker_present: np.ndarray,
                     cfg: keyframes.KeyframeConfig) -> np.ndarray:
    """Selected keyframes plus the first and last frame of every marker run
    (edges between marker-bearing keyframes carry metric scale)."""
    kf_mask = keyframes.select_keyframes(abs_poses, np.asarray(n_inliers), cfg)
    mp = np.asarray(marker_present, bool)
    if mp.any():
        d = np.diff(mp.astype(np.int8))
        kf_mask[np.flatnonzero(d == 1) + 1] = True  # run starts
        kf_mask[np.flatnonzero(d == -1)] = True  # run ends
        kf_mask[0] |= mp[0]
        kf_mask[-1] |= mp[-1]
    return np.where(kf_mask)[0]


def bridge_pairs(marker_present: np.ndarray, kf_idx: np.ndarray) -> tuple[list[int], list[int]]:
    """Keyframe positions of the marker-bearing frames flanking each maximal
    marker-absent run: one direct candidate edge per marker gap."""
    mp = np.asarray(marker_present, bool)
    bridge_a: list[int] = []
    bridge_b: list[int] = []
    if mp.any():
        d = np.diff(mp.astype(np.int8))
        gap_last_before = np.flatnonzero(d == -1)  # last marker frame pre-gap
        gap_first_after = np.flatnonzero(d == 1) + 1  # first post-gap
        kf_pos = {int(f): p for p, f in enumerate(kf_idx)}
        for s in gap_last_before:
            nxt = gap_first_after[gap_first_after > s]
            if len(nxt) and int(s) in kf_pos and int(nxt[0]) in kf_pos:
                bridge_a.append(kf_pos[int(s)])
                bridge_b.append(kf_pos[int(nxt[0])])
    return bridge_a, bridge_b


def loop_graph(
    abs_kf: np.ndarray,
    kf_idx: np.ndarray,
    edges: loop_closure.LoopEdges,
    n_inliers: np.ndarray,
    cfg: PoseGraphRefineConfig,
    pair_scale_ok: np.ndarray | None,
    device,
) -> pose_graph.PoseGraph:
    """The keyframe graph: nodes mTc = inv(cTm), sequential edges weighted by
    whether their span ran on live marker scale, loop edges with isotropic
    (metric) or projector (scale-free) information scaled by inlier support
    relative to the chain's median pair and discounted by restart
    dispersion (the reference's weights, refine.py:355-413)."""
    X = torch.as_tensor(np.linalg.inv(abs_kf).astype(np.float32), device=device)
    graph = pose_graph.sequential_edges(X)
    if pair_scale_ok is not None:
        seq_w = np.empty(len(kf_idx) - 1, np.float32)
        for s in range(len(kf_idx) - 1):
            span = pair_scale_ok[kf_idx[s] : kf_idx[s + 1]]
            live = bool(np.all(span)) if len(span) else True
            seq_w[s] = cfg.seq_weight_live if live else cfg.seq_weight_held
        graph = graph._replace(edge_weight=torch.as_tensor(seq_w, device=device))

    loop_meas = torch.as_tensor(np.linalg.inv(edges.rel).astype(np.float32), device=device)
    seq_med = float(np.median(np.asarray(n_inliers))) if len(n_inliers) else 1.0
    rel_prec = torch.as_tensor(
        np.clip(np.asarray(edges.n_inliers, np.float64) / max(seq_med, 1.0), 0.02, 2.0),
        dtype=torch.float32, device=device,
    )
    eye6 = torch.eye(6, dtype=torch.float32, device=device)
    metric_w = (cfg.lc.weight * rel_prec)[:, None, None] * eye6.expand(len(edges.i), 6, 6)
    free_w = rel_prec[:, None, None] * pose_graph.scale_free_weight(
        loop_meas,
        w_rot=cfg.lc.weight * cfg.loop_rot_weight_scale_free,
        w_dir=cfg.lc.weight * cfg.loop_dir_weight_scale_free,
    )
    loop_w = torch.where(torch.as_tensor(edges.scale_ok, device=device)[:, None, None], metric_w, free_w)
    # Per-block dispersion discount: translation at [:3, :3], rotation at [3:, 3:].
    rot_mult = 1.0 / (1.0 + (edges.rot_disp_deg / cfg.edge_rot_disp_deg0) ** 2)
    dir_mult = 1.0 / (1.0 + (edges.dir_disp_deg / cfg.edge_dir_disp_deg0) ** 2)
    disc = np.zeros((len(edges.i), 6, 6), np.float32)
    disc[:, :3, :3] = dir_mult[:, None, None]
    disc[:, 3:, 3:] = rot_mult[:, None, None]
    loop_w = loop_w * torch.as_tensor(disc, device=device)
    return pose_graph.add_edges(graph, edges.i, edges.j, loop_meas, loop_w)


def pose_graph_trajectory(
    frames,  # (N, H, W) float frames (undistorted) or callable idx -> frames
    abs_poses: np.ndarray,  # (N, 4, 4) VO absolute poses (cTm)
    n_inliers: np.ndarray,  # (N-1,)
    marker_corners: np.ndarray,  # (N, 4, 2) undistorted corners (NaN absent)
    marker_present: np.ndarray,  # (N,)
    K,
    real_marker_length: float,
    vo_cfg,
    cfg: PoseGraphRefineConfig | None = None,
    pair_scale_ok: np.ndarray | None = None,  # (N-1,) live-marker-scale bits
    draws=None,  # replayed verification uniforms, see loop_closure.find_loop_closures
) -> tuple[np.ndarray, dict]:
    """Keyframes -> loop-closure retrieval/verification -> pose-graph
    optimisation -> trajectory correction, on one device.

    Returns (refined (N, 4, 4) absolute poses, info dict with the reference's
    keys; pg_mesh_devices is 1: the edge-sharded product is ROADMAP A13).
    """
    cfg = cfg or PoseGraphRefineConfig()
    abs_poses = np.asarray(abs_poses, np.float64)
    kf_idx = keyframe_indices(abs_poses, n_inliers, marker_present, cfg.kf)
    info: dict = {"n_keyframes": len(kf_idx), "n_loop_edges": 0}
    if len(kf_idx) < cfg.lc.min_gap + 2:
        return abs_poses.copy(), info

    feats = detect_and_describe_batch(
        _frame_fetcher(frames)(kf_idx), k=cfg.n_keypoints, threshold=cfg.fast_threshold
    )
    bridge_a, bridge_b = bridge_pairs(marker_present, kf_idx)
    edges = loop_closure.find_loop_closures(
        feats,
        abs_poses[kf_idx],
        np.asarray(marker_corners)[kf_idx],
        np.asarray(marker_present)[kf_idx],
        K,
        real_marker_length,
        vo_cfg,
        cfg.lc,
        extra_pairs=(np.asarray(bridge_a), np.asarray(bridge_b)) if bridge_a else None,
        draws=draws,
    )
    info["n_bridge_pairs"] = len(bridge_a)
    info["n_loop_edges"] = int(len(edges.i))
    info["loop_pairs"] = list(zip(edges.i.tolist(), edges.j.tolist()))
    if len(edges.i) == 0:
        return abs_poses.copy(), info

    graph = loop_graph(abs_poses[kf_idx], kf_idx, edges, n_inliers, cfg, pair_scale_ok, feats.desc.device)
    info["edge_rot_disp_deg"] = [round(float(v), 2) for v in edges.rot_disp_deg]
    info["edge_dir_disp_deg"] = [round(float(v), 2) for v in edges.dir_disp_deg]
    # Powers-of-two buckets for (M, E), as the reference pads its graphs.
    M = int(graph.poses.shape[0])
    graph = pose_graph.pad_graph(
        graph, pose_graph.next_bucket(M), pose_graph.next_bucket(int(graph.edge_i.shape[0]))
    )
    res = pose_graph.optimize(graph, cfg.pg)
    info["pg_initial_cost"] = float(res.initial_cost)
    info["pg_final_cost"] = float(res.final_cost)
    info["pg_mesh_devices"] = 1
    refined_kf = np.linalg.inv(res.poses[:M].cpu().numpy().astype(np.float64))
    return reanchor_segments(abs_poses, kf_idx, refined_kf), info
