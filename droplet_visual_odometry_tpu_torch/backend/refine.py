"""Trajectory refinement over a VO run — port of
droplet_visual_odometry_tpu/backend/refine.py. Two backends, host
orchestration in numpy, device work on the frames' device:

  refine_trajectory     keyframes -> sliding windows of feature tracks ->
                        windowed BA (backend/ba.py) -> trust gates ->
                        trajectory correction;
  pose_graph_trajectory keyframes -> loop-closure retrieval and verification
                        -> pose-graph optimisation -> trajectory correction.

Both take the frames as a tensor or as a callable idx -> frames (the
streaming path, where whole-sequence frames never exist on the device).

Spans (utils/profiling): `refine.pose_graph` around pose_graph_trajectory,
holding `refine.keyframes` (selection and bridge pairs, count
`keyframes`), `refine.fetch` (the keyframes' gather, copy and remap; a
streamed fetch holds a `refine.gather` and a `refine.upload` per staging
block and counts `frames`, `blocks` and `pinned`, see pipeline.HostFetcher),
`refine.features` (the keyframe frontend), loop closure's `loop.*`,
`refine.graph` (the loop graph and its padding), `pg.optimize` (the GN
replays and the result's fetch) and `refine.reanchor`; `refine.ba`
around refine_trajectory, holding `refine.keyframes` (count
`keyframes`), its own `refine.fetch`, `refine.features` (the keyframe
frontend and the consecutive match, with its device interval), one
`ba.window` per window walked (counts `keyframes`, `tracks` over
min_views, `observations` in the BA mask, `skipped`, `accepted`) and
`refine.reanchor`. A window holds `ba.tracks` (build, triangulate,
filter and the track count's read-back), and unless skipped `ba.solve`
(run_ba and its read-back, with its device interval; count `ba_kernel`, 1
when the LM loop ran in the kernel csrc/windowed_ba.cu, 0 when it ran as
the captured op-by-op program) and `ba.gate`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from droplet_visual_odometry_tpu_torch.backend import ba, keyframes, loop_closure, pose_graph, tracks
from droplet_visual_odometry_tpu_torch.estimation.scale import canonical_corners
from droplet_visual_odometry_tpu_torch.frontend.features import detect_and_describe_batch
from droplet_visual_odometry_tpu_torch.frontend.matcher import Matches
from droplet_visual_odometry_tpu_torch.frontend.orb import Features
from droplet_visual_odometry_tpu_torch.parallel import sharding
from droplet_visual_odometry_tpu_torch.utils import profiling


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


# The windowed BA's geometry (triangulation, the reprojection filter and the
# LM loop) runs in float64. Where a window's keyframes nearly coincide (a
# hover or a turn, keyframes then forced by max_gap millimetres apart) its
# scale and its landmarks' depths are barely observable, and a float32 solve
# lands anywhere along that valley: centimetres apart between the captured
# graph and the op-by-op run of one window, tens of centimetres along a
# chain of windows. ORB-SLAM2's local BA (g2o) is double too.
BA_DTYPE = torch.float64


@dataclasses.dataclass(frozen=True)
class RefineConfig:
    """Same fields and defaults as the reference's RefineConfig (see its
    comments on min_views and the two trust gates)."""

    window: int = 8  # keyframes per BA window
    kf: keyframes.KeyframeConfig = keyframes.KeyframeConfig()
    ba: ba.BAConfig = ba.BAConfig(n_fixed=2)  # the first two poses carry the marker-metric scale
    n_keypoints: int = 512
    fast_threshold: float = 20.0
    reproj_filter_px: float = 3.0
    min_views: int = 3
    marker_gate_tol_px: float = 0.5  # marker gate: windows with marker-bearing keyframes
    max_rot_correction_deg: float = 3.0  # magnitude gate: marker-free windows
    max_trans_correction_frac: float = 0.5  # of the window's chain span


def _marker_reproj_err(poses: np.ndarray, K_np: np.ndarray, corners_obs: np.ndarray, L: float) -> float | None:
    """Mean pixel error of the known-size marker square reprojected by cTm
    poses against its observed (undistorted) corners; None without any."""
    obj = canonical_corners(float(L)).numpy().astype(np.float64)  # (4, 3)
    errs = []
    for p, c in zip(np.asarray(poses, np.float64), corners_obs):
        if not np.all(np.isfinite(c)):
            continue
        pc = (p[:3, :3] @ obj.T).T + p[:3, 3]
        z = np.maximum(pc[:, 2], 1e-6)
        u = K_np[0, 0] * pc[:, 0] / z + K_np[0, 2]
        v = K_np[1, 1] * pc[:, 1] / z + K_np[1, 2]
        errs.append(float(np.mean(np.hypot(u - c[:, 0], v - c[:, 1]))))
    return float(np.mean(errs)) if errs else None


def _gate(new_poses: np.ndarray, old_poses: np.ndarray, cost_ok: bool, m_before, m_after,
          cfg: RefineConfig) -> tuple[bool, dict]:
    """Trust gates on a window's output: the marker gate where the window has
    marker observations, else the correction-magnitude gate."""
    if m_before is not None:
        return cost_ok and m_after <= m_before + cfg.marker_gate_tol_px, {
            "marker_px": (round(m_before, 3), round(m_after, 3))}
    dR = np.einsum("wij,wkj->wik", new_poses[:, :3, :3], old_poses[:, :3, :3])
    rot_corr = np.degrees(np.arccos(np.clip((np.trace(dR, axis1=1, axis2=2) - 1) / 2, -1, 1)))
    trans_corr = np.linalg.norm(new_poses[:, :3, 3] - old_poses[:, :3, 3], axis=1)
    span = float(np.sum(np.linalg.norm(np.diff(old_poses[:, :3, 3], axis=0), axis=1)))
    accept = (cost_ok and float(rot_corr.max()) <= cfg.max_rot_correction_deg
              and float(trans_corr.max()) <= cfg.max_trans_correction_frac * max(span, 1e-9))
    return accept, {"rot_deg": round(float(rot_corr.max()), 3),
                    "trans_frac": round(float(trans_corr.max()) / max(span, 1e-9), 4)}


@profiling.span("refine.ba")
def refine_trajectory(
    frames,  # (N, H, W) float frames (undistorted) or callable idx -> frames
    abs_poses: np.ndarray,  # (N, 4, 4) VO absolute poses (cTm)
    n_inliers: np.ndarray,  # (N-1,)
    K,
    cfg: RefineConfig = RefineConfig(),
    marker_corners: np.ndarray | None = None,  # (N, 4, 2) undistorted, NaN absent
    real_marker_length: float | None = None,
) -> tuple[np.ndarray, dict]:
    """Smooth a VO trajectory with sliding-window BA.

    Keyframes come from select_keyframes; one frontend pass over the
    keyframe stack and one match of all its consecutive pairs feed every
    window. Windows of cfg.window keyframes overlap by their two fixed
    keyframes; a window with fewer than 12 tracks over min_views is skipped.
    marker_corners/real_marker_length arm the marker gate.

    Returns (refined (N, 4, 4) absolute poses, info dict with the
    reference's keys).
    """
    abs_poses = np.asarray(abs_poses, np.float64)
    with profiling.span("refine.keyframes") as rec:
        kf_idx = np.where(keyframes.select_keyframes(abs_poses, np.asarray(n_inliers), cfg.kf))[0]
        rec.set(keyframes=len(kf_idx))
    info: dict = {"n_keyframes": len(kf_idx), "windows": 0, "rms_px": []}
    if len(kf_idx) < 3:
        return abs_poses.copy(), info

    with profiling.span("refine.fetch"):
        kf_frames = _frame_fetcher(frames)(kf_idx)
    with profiling.span("refine.features", device=kf_frames.device):
        feats = detect_and_describe_batch(kf_frames, k=cfg.n_keypoints, threshold=cfg.fast_threshold)
        del kf_frames
        matches = tracks.match_consecutive(feats)
    dev = feats.xy.device
    Kt = torch.as_tensor(np.asarray(K), dtype=BA_DTYPE, device=dev)
    K_np = np.asarray(K, np.float64)
    refined_kf = abs_poses[kf_idx].copy()  # cTw with world = the marker frame
    W = min(cfg.window, len(kf_idx))

    start = 0
    while start < len(kf_idx) - 2:
        end = min(start + W, len(kf_idx))
        sl = slice(start, end)
        with profiling.span("ba.window", keyframes=end - start) as win:
            with profiling.span("ba.tracks"):
                poses0 = torch.as_tensor(refined_kf[sl], dtype=BA_DTYPE, device=dev)
                grid = tracks.build_tracks(Features(*(a[sl] for a in feats)),
                                           Matches(*(a[start : end - 1] for a in matches)))
                grid = grid._replace(obs_uv=grid.obs_uv.to(BA_DTYPE))
                X, valid = tracks.triangulate_tracks(grid, poses0, Kt, min_views=cfg.min_views)
                grid = tracks.filter_by_reprojection(grid, X, poses0, Kt, cfg.reproj_filter_px, cfg.min_views)
                mask = grid.obs_mask & valid[None, :]
                n_tracks = int(torch.sum(torch.sum(mask, 0) >= cfg.min_views))
            win.set(tracks=n_tracks, observations=torch.sum(mask), skipped=int(n_tracks < 12), accepted=0)
            if n_tracks < 12:
                start += W - 2
                continue

            with profiling.span("ba.solve", device=dev) as solve:
                window = ba.BAWindow(poses=poses0, points=X, obs_uv=grid.obs_uv, obs_mask=mask, K=Kt)
                res = ba.run_ba(window, cfg.ba)
                solve.set(ba_kernel=int(ba.runs_in_kernel(window)))
                new_poses = res.poses.cpu().numpy().astype(np.float64)
                final_cost = float(res.final_cost)
                initial_cost = float(res.initial_cost)
            with profiling.span("ba.gate"):
                old_poses = refined_kf[sl]
                cost_ok = final_cost <= initial_cost and np.isfinite(final_cost)
                m_before = m_after = None
                if marker_corners is not None and real_marker_length is not None:
                    obs = np.asarray(marker_corners, np.float64)[kf_idx[sl]]
                    m_before = _marker_reproj_err(old_poses, K_np, obs, real_marker_length)
                    m_after = _marker_reproj_err(new_poses, K_np, obs, real_marker_length)
                accept, rec = _gate(new_poses, old_poses, cost_ok, m_before, m_after, cfg)
                rec["accepted"] = accept
                info.setdefault("window_corr", []).append(rec)
                if accept:
                    refined_kf[sl] = new_poses
                    info["rms_px"].append(float(res.rms_px))
                info["windows"] += 1
            win.set(accepted=int(accept))
        # Overlap the next window by the two fixed (anchor) keyframes.
        start += max(W - 2, 1)

    with profiling.span("refine.reanchor"):
        return reanchor_segments(abs_poses, kf_idx, refined_kf), info


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


@profiling.span("refine.pose_graph")
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
    mesh="auto",  # parallel.sharding.Mesh | None | "auto"
) -> tuple[np.ndarray, dict]:
    """Keyframes -> loop-closure retrieval/verification -> pose-graph
    optimisation -> trajectory correction, on the frames' device.

    mesh: the mesh for the edge-sharded Hessian-vector products inside
    pose_graph.optimize. "auto" (default) shards over the default process
    group when torch.distributed is initialised with more than one rank,
    and runs on one device otherwise; None forces one device. Every rank of
    the mesh runs the whole call (VO outputs, keyframes and loop closure are
    replicated); only the product is sharded.

    Returns (refined (N, 4, 4) absolute poses, info dict with the reference's
    keys; pg_mesh_devices is the mesh's size).
    """
    cfg = cfg or PoseGraphRefineConfig()
    abs_poses = np.asarray(abs_poses, np.float64)
    with profiling.span("refine.keyframes") as rec:
        kf_idx = keyframe_indices(abs_poses, n_inliers, marker_present, cfg.kf)
        bridge_a, bridge_b = bridge_pairs(marker_present, kf_idx)
        rec.set(keyframes=len(kf_idx))
    info: dict = {"n_keyframes": len(kf_idx), "n_loop_edges": 0}
    if len(kf_idx) < cfg.lc.min_gap + 2:
        return abs_poses.copy(), info

    with profiling.span("refine.fetch"):
        kf_frames = _frame_fetcher(frames)(kf_idx)
    with profiling.span("refine.features", device=kf_frames.device):
        feats = detect_and_describe_batch(kf_frames, k=cfg.n_keypoints, threshold=cfg.fast_threshold)
    del kf_frames  # the keyframes' pixels end with the frontend: verification's peak must not hold them
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

    with profiling.span("refine.graph"):
        graph = loop_graph(abs_poses[kf_idx], kf_idx, edges, n_inliers, cfg, pair_scale_ok, feats.desc.device)
        info["edge_rot_disp_deg"] = [round(float(v), 2) for v in edges.rot_disp_deg]
        info["edge_dir_disp_deg"] = [round(float(v), 2) for v in edges.dir_disp_deg]
        # Powers-of-two buckets for (M, E), as the reference pads its graphs.
        M = int(graph.poses.shape[0])
        graph = pose_graph.pad_graph(
            graph, pose_graph.next_bucket(M), pose_graph.next_bucket(int(graph.edge_i.shape[0]))
        )
    if isinstance(mesh, str):
        if mesh != "auto":
            raise ValueError(f"mesh must be a Mesh, None or 'auto'; got {mesh!r}")
        mesh = None
        if sharding.initialised() and dist.get_world_size() > 1:
            mesh = sharding.make_mesh(axis_name="edges", device=graph.poses.device)
    with profiling.span("pg.optimize", device=graph.poses.device):
        res = pose_graph.optimize(graph, cfg.pg, mesh=mesh)
        info["pg_initial_cost"] = float(res.initial_cost)
        info["pg_final_cost"] = float(res.final_cost)
        poses_kf = res.poses[:M].cpu().numpy()
    info["pg_mesh_devices"] = 1 if mesh is None else mesh.size
    with profiling.span("refine.reanchor"):
        refined_kf = np.linalg.inv(poses_kf.astype(np.float64))
        return reanchor_segments(abs_poses, kf_idx, refined_kf), info
