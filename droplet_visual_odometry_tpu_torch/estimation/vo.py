"""The visual-odometry core: two-frame relative pose + sequence chaining —
port of droplet_visual_odometry_tpu/estimation/vo.py.

The frontend runs once over all frames; then all N-1 pairs are matched and
estimated at once (the reference's vmap over pairs is the leading pair
dimension here); the 'hold' scale fill and the pose chain finish the run.
On the card `run_sequence` is one captured CUDA graph per (N, H, W, frame
dtype, VOConfig, draw form), as the reference's is one jitted program
(utils/graphs.py); `run_sequence_eager` is the same program op by op.

Pose conventions (unchanged): rel = curr_T_prev, abs_curr = rel @ abs_prev.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import torch

from droplet_visual_odometry_tpu_torch.core import se3
from droplet_visual_odometry_tpu_torch.estimation import scale as scale_mod
from droplet_visual_odometry_tpu_torch.estimation.ransac import RansacConfig, ransac_pose
from droplet_visual_odometry_tpu_torch.frontend import matcher
from droplet_visual_odometry_tpu_torch.frontend.features import detect_and_describe_batch
from droplet_visual_odometry_tpu_torch.frontend.orb import Features
from droplet_visual_odometry_tpu_torch.utils import graphs, profiling, threefry


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
    u_hyp: torch.Tensor | None = None,
    u_lo: torch.Tensor | None = None,
    keys: torch.Tensor | None = None,
) -> VOStepResult:
    """P frame pairs -> scaled relative poses: match, LO-RANSAC + pose, marker
    scale. Degenerate pairs yield rel = identity with ok = False. RANSAC
    draws from the pairs' keys (P, 2) or the injected u_hyp/u_lo.

    Captured, the match is the stage `vo.match` (profiling.device_stage),
    counting its pairs, keypoints, descriptor length (`dim`: 8 words for
    ORB) and `l2_kernel`, 1 when a float match runs in csrc/l2_match.cu
    (float sets on a CUDA device), 0 otherwise."""
    desc = feats_prev.desc
    with profiling.device_stage("vo.match", pairs=desc.shape[0], keypoints=desc.shape[1], dim=desc.shape[-1],
                                l2_kernel=int(desc.is_floating_point() and desc.device.type == "cuda")):
        m = matcher.match(
            feats_prev.desc, feats_curr.desc, feats_prev.valid, feats_curr.valid,
            mode=cfg.match_mode, ratio=cfg.ratio,
        )
    p_prev, p_curr, valid = matcher.gather_correspondences(feats_prev.xy, feats_curr.xy, m)
    n_matches = torch.sum(valid, dim=-1).to(torch.int32)

    R, t_unit, res = ransac_pose(p_prev, p_curr, valid, K, cfg.ransac, u_hyp, u_lo, keys)
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
    associative 'last valid' scan as an index prefix-max (exact). Inside a
    captured program init_scale is a device tensor (no host data)."""
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


def _sequence_body(
    frames: torch.Tensor,
    corners: torch.Tensor,
    present: torch.Tensor,
    init_pose: torch.Tensor,
    K: torch.Tensor,
    init_scale: torch.Tensor,
    key: torch.Tensor | None,
    u_hyp: torch.Tensor | None,
    u_lo: torch.Tensor | None,
    *,
    cfg: VOConfig,
    real_marker_length: float,
) -> VOTrajectory:
    """The program of run_sequence, on staged device tensors: corners (N, 4,
    2) float32 with NaN where absent, present (N,) bool, init_pose (4, 4)
    and K (3, 3) float32, init_scale () float32, and either the run key (2,)
    int64 or u_hyp/u_lo. No host read and no host data inside.

    Captured, the body times its two stages on every replay
    (profiling.device_stage): `vo.frontend` (the draws' keys, pyramid,
    FAST, NMS/top-k, blur, describe; with a float frontend it holds
    `vo.float_detect` and `vo.float_describe`) and `vo.solver` (match,
    LO-RANSAC, scale, chain; it holds `vo.match`)."""
    n = frames.shape[0]
    with profiling.device_stage("vo.frontend", frames=n):
        keys = None
        if u_hyp is None:
            keys = threefry.split(key, n - 1)
        corners = torch.nan_to_num(corners)

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
    with profiling.device_stage("vo.solver", frames=n):
        feats_prev = Features(*(a[:-1] for a in feats))
        feats_curr = Features(*(a[1:] for a in feats))
        res = two_frame_vo(
            feats_prev, feats_curr, corners[:-1], corners[1:], present[:-1] & present[1:],
            K, real_marker_length, cfg, u_hyp, u_lo, keys,
        )

        if cfg.scale_mode == "hold":
            scales = hold_fill(res.scale, res.scale_ok, init_scale)
            rels = res.rel_unit.clone()
            rels[:, :3, 3] = rels[:, :3, 3] * scales[:, None]
        else:
            scales = res.scale
            rels = res.rel
        abs_poses = chain_poses(init_pose, rels)

    return VOTrajectory(
        abs_poses=abs_poses,
        rel_poses=rels,
        n_matches=res.n_matches,
        n_inliers=res.n_inliers,
        scales=scales,
        scale_ok=res.scale_ok,
        ok=res.ok,
    )


def _sequence_program(
    frames, marker_corners, marker_present, init_pose, K, real_marker_length, cfg, seed, u_hyp, u_lo,
    init_scale, key,
) -> tuple[tuple, dict]:
    """run_sequence's arguments as the program's inputs (host values become
    tensors here, outside the program) and its static part."""
    if cfg.scale_mode not in ("marker", "hold"):
        raise ValueError(f"unknown scale_mode: {cfg.scale_mode}")
    if u_hyp is None:
        key = threefry.prng_key(seed, frames.device) if key is None else key
    else:
        key = None
    f32 = torch.float32
    inputs = (
        frames, torch.as_tensor(marker_corners, dtype=f32), torch.as_tensor(marker_present, dtype=torch.bool),
        torch.as_tensor(init_pose, dtype=f32), torch.as_tensor(K, dtype=f32),
        torch.as_tensor(init_scale, dtype=f32).reshape(()), key, u_hyp, u_lo,
    )
    return inputs, dict(cfg=cfg, real_marker_length=float(real_marker_length))


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
    init_scale: float | torch.Tensor = 1.0,
    init_scale_seen: bool | torch.Tensor = False,
    *,
    key: torch.Tensor | None = None,
) -> VOTrajectory:
    """Per-pair VO over a sequence of (N, H, W) undistorted frames, on their device.

    RANSAC draws are the reference's: pair i's key is split(key, N-1)[i]
    (vo.py:189), with key = PRNGKey(seed) unless `key` (two uint32 words in
    an int64 tensor, the reference's `key` argument) is given; or they are
    the injected uniforms u_hyp (P, B*8) and u_lo (P, 128*14), P = N-1.

    init_scale/init_scale_seen: the carry of scale_mode='hold' across
    chunked runs (utils/checkpoint.py): the last held scale of the previous
    chunk and whether a live scale has been seen. The fill holds init_scale
    until the chunk's first live scale; as in the reference, the seen flag
    does not change the filled values.

    On a CUDA device this replays the program captured for the call's
    static signature (captured at its first call); host values (corners,
    flags, poses, K, init_scale, the seed's key) are staged into the
    program's inputs outside it. Elsewhere it runs the body eagerly.
    """
    inputs, static = _sequence_program(
        frames, marker_corners, marker_present, init_pose, K, real_marker_length, cfg, seed, u_hyp, u_lo,
        init_scale, key,
    )
    body = functools.partial(_sequence_body, **static)
    return graphs.run("run_sequence", body, inputs, tuple(static.values()), frames.device)


def run_sequence_eager(
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
    init_scale: float | torch.Tensor = 1.0,
    init_scale_seen: bool | torch.Tensor = False,
    *,
    key: torch.Tensor | None = None,
) -> VOTrajectory:
    """run_sequence op by op on any device: the captured program's twin."""
    inputs, static = _sequence_program(
        frames, marker_corners, marker_present, init_pose, K, real_marker_length, cfg, seed, u_hyp, u_lo,
        init_scale, key,
    )
    return _sequence_body(*(None if x is None else x.to(frames.device) for x in inputs), **static)
