"""The visual-odometry core: two-frame relative pose + sequence chaining —
port of droplet_visual_odometry_tpu/estimation/vo.py.

The frontend runs once over all frames; then all N-1 pairs are matched and
estimated at once (the reference's vmap over pairs is the leading pair
dimension here); the 'hold' scale fill and the pose chain finish the run.

Pose conventions (unchanged): rel = curr_T_prev, abs_curr = rel @ abs_prev.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from droplet_visual_odometry_tpu_torch.core import se3
from droplet_visual_odometry_tpu_torch.estimation import scale as scale_mod
from droplet_visual_odometry_tpu_torch.estimation.ransac import RansacConfig, ransac_pose
from droplet_visual_odometry_tpu_torch.frontend import matcher
from droplet_visual_odometry_tpu_torch.frontend.features import detect_and_describe_batch
from droplet_visual_odometry_tpu_torch.frontend.orb import Features


@dataclasses.dataclass(frozen=True)
class VOConfig:
    """Same fields and defaults as the reference's VOConfig (see its comments)."""

    n_keypoints: int = 512
    frontend: str = "orb"
    fast_threshold: float = 20.0
    fast_arc_length: int = 9
    dog_threshold: float = 1.0
    n_levels: int = 4
    scale_factor: float = 1.32
    match_mode: str = "crosscheck"
    ratio: float = 0.75
    ransac: RansacConfig = RansacConfig()
    min_matches: int = 12
    scale_side: str = "mean"
    scale_estimator: str = "gn"
    scale_mode: str = "marker"


class VOStepResult(NamedTuple):
    """Per-pair results, each with a leading pair dimension P."""

    rel: torch.Tensor  # (P, 4, 4) scaled curr_T_prev (identity when degenerate)
    rel_unit: torch.Tensor  # (P, 4, 4) the same pose with unit-norm translation
    n_matches: torch.Tensor  # (P,) int32
    n_inliers: torch.Tensor  # (P,) int32
    scale: torch.Tensor  # (P,) float32
    scale_ok: torch.Tensor  # (P,) bool — scale came from a live marker fit
    ok: torch.Tensor  # (P,) bool — enough matches/inliers to trust the step


def two_frame_vo(
    feats_prev: Features,
    feats_curr: Features,
    prev_marker_corners: torch.Tensor,
    curr_marker_corners: torch.Tensor,
    marker_valid: torch.Tensor,
    K: torch.Tensor,
    real_marker_length: float,
    cfg: VOConfig,
    generator: torch.Generator | None = None,
    u_hyp: torch.Tensor | None = None,
    u_lo: torch.Tensor | None = None,
) -> VOStepResult:
    """P frame pairs -> scaled relative poses: match, LO-RANSAC + pose, marker
    scale. Degenerate pairs yield rel = identity with ok = False."""
    m = matcher.match(
        feats_prev.desc, feats_curr.desc, feats_prev.valid, feats_curr.valid,
        mode=cfg.match_mode, ratio=cfg.ratio,
    )
    p_prev, p_curr, valid = matcher.gather_correspondences(feats_prev.xy, feats_curr.xy, m)
    n_matches = torch.sum(valid, dim=-1).to(torch.int32)

    R, t_unit, res = ransac_pose(p_prev, p_curr, valid, K, cfg.ransac, generator, u_hyp, u_lo)
    s, s_ok = scale_mod.scale_factor_with_valid(
        K, R, t_unit, prev_marker_corners, curr_marker_corners, real_marker_length, marker_valid,
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


class VOTrajectory(NamedTuple):
    """Sequence result: absolute + relative pose streams and diagnostics."""

    abs_poses: torch.Tensor  # (N, 4, 4) — abs_0 = init_pose
    rel_poses: torch.Tensor  # (N-1, 4, 4)
    n_matches: torch.Tensor  # (N-1,)
    n_inliers: torch.Tensor  # (N-1,)
    scales: torch.Tensor  # (N-1,) applied scale (post-fill in 'hold' mode)
    scale_ok: torch.Tensor  # (N-1,) pair had a LIVE marker scale (pre-fill)
    ok: torch.Tensor  # (N-1,)


def hold_fill(scales: torch.Tensor, scale_ok: torch.Tensor, init_scale: float | torch.Tensor) -> torch.Tensor:
    """Forward-fill the last live scale, seeded by init_scale: the reference's
    associative 'last valid' scan as an index prefix-max (exact)."""
    s_seed = torch.cat([torch.as_tensor(init_scale, dtype=torch.float32, device=scales.device).reshape(1), scales])
    live = torch.cat([torch.ones(1, dtype=torch.bool, device=scales.device), scale_ok])
    idx = torch.where(live, torch.arange(live.numel(), device=scales.device), torch.zeros_like(live, dtype=torch.int64))
    return s_seed[torch.cummax(idx, dim=0).values][1:]


def chain_poses(init_pose: torch.Tensor, rels: torch.Tensor) -> torch.Tensor:
    """abs_0 = init_pose, abs_i = rel_i @ abs_(i-1): the reference's
    associative scan as a plain prefix loop."""
    out = [init_pose]
    for i in range(rels.shape[0]):
        out.append(rels[i] @ out[-1])
    return torch.stack(out)


def run_sequence(
    frames: torch.Tensor,
    marker_corners: torch.Tensor,
    marker_present: torch.Tensor,
    init_pose: torch.Tensor,
    K: torch.Tensor,
    real_marker_length: float,
    cfg: VOConfig = VOConfig(),
    seed: int = 0,
    u_hyp: torch.Tensor | None = None,
    u_lo: torch.Tensor | None = None,
) -> VOTrajectory:
    """Per-pair VO over a sequence of (N, H, W) undistorted frames, on their device.

    RANSAC draws come from a torch.Generator on the frames' device seeded
    with `seed`, or from injected uniforms u_hyp (P, B*8) and u_lo
    (P, 128*14), P = N-1, to replay the reference's per-pair draws.
    The 'hold' fill starts from scale 1.0; the reference's chunk carry
    (init_scale, init_scale_seen) arrives with the chunked streaming path.
    """
    if cfg.scale_mode not in ("marker", "hold"):
        raise ValueError(f"unknown scale_mode: {cfg.scale_mode}")
    dev = frames.device
    K = torch.as_tensor(K, dtype=torch.float32, device=dev)
    corners = torch.nan_to_num(torch.as_tensor(marker_corners, dtype=torch.float32, device=dev))
    present = torch.as_tensor(marker_present, dtype=torch.bool, device=dev)
    generator = torch.Generator(device=dev).manual_seed(seed)

    feats = detect_and_describe_batch(
        frames,
        k=cfg.n_keypoints,
        threshold=cfg.fast_threshold,
        arc_length=cfg.fast_arc_length,
        mode=cfg.frontend,
        dog_threshold=cfg.dog_threshold,
        n_levels=cfg.n_levels if cfg.frontend == "orb" else 1,
        scale_factor=cfg.scale_factor,
    )
    feats_prev = Features(*(a[:-1] for a in feats))
    feats_curr = Features(*(a[1:] for a in feats))
    res = two_frame_vo(
        feats_prev, feats_curr, corners[:-1], corners[1:], present[:-1] & present[1:],
        K, real_marker_length, cfg, generator, u_hyp, u_lo,
    )

    if cfg.scale_mode == "hold":
        scales = hold_fill(res.scale, res.scale_ok, 1.0)
        rels = res.rel_unit.clone()
        rels[:, :3, 3] = rels[:, :3, 3] * scales[:, None]
    else:
        scales = res.scale
        rels = res.rel

    abs_poses = chain_poses(torch.as_tensor(init_pose, dtype=torch.float32, device=dev), rels)
    return VOTrajectory(
        abs_poses=abs_poses,
        rel_poses=rels,
        n_matches=res.n_matches,
        n_inliers=res.n_inliers,
        scales=scales,
        scale_ok=res.scale_ok,
        ok=res.ok,
    )
