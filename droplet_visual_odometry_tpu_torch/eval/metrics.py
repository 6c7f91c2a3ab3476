"""Trajectory evaluation: ATE / RPE — port of droplet_visual_odometry_tpu/eval/metrics.py.

Host-side like the reference: ATE in float64 numpy, RPE's pose algebra in
float32 (as the reference's jnp arrays are), on the CPU.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from droplet_visual_odometry_tpu_torch.core import se3


def umeyama_alignment(
    src: np.ndarray, dst: np.ndarray, with_scale: bool = False
) -> tuple[np.ndarray, np.ndarray, float]:
    """Least-squares similarity/rigid alignment src -> dst ((N, 3) each):
    (R, t, s) minimising ||dst - (s R src + t)||^2 (Umeyama 1991)."""
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    s = float(np.trace(np.diag(D) @ S) / max((xs**2).sum() / len(src), 1e-12)) if with_scale else 1.0
    return R, mu_d - s * R @ mu_s, s


class ATEResult(NamedTuple):
    rmse: float
    mean: float
    median: float
    max: float
    errors: np.ndarray  # (N,) per-frame translation errors


def ate(gt_poses: np.ndarray, est_poses: np.ndarray, align: str = "none") -> ATEResult:
    """Absolute trajectory error between (N, 4, 4) pose streams; align is
    'none' (raw translations), 'se3' or 'sim3' (Umeyama first)."""
    gt_t = np.asarray(gt_poses, np.float64)[:, :3, 3]
    es_t = np.asarray(est_poses, np.float64)[:, :3, 3]
    if align != "none":
        R, t, s = umeyama_alignment(es_t, gt_t, with_scale=(align == "sim3"))
        es_t = (s * (R @ es_t.T)).T + t
    err = np.linalg.norm(gt_t - es_t, axis=1)
    return ATEResult(
        rmse=float(np.sqrt((err**2).mean())),
        mean=float(err.mean()),
        median=float(np.median(err)),
        max=float(err.max()),
        errors=err,
    )


class RPEResult(NamedTuple):
    trans_rmse: float
    rot_rmse_deg: float
    trans_errors: np.ndarray
    rot_errors_deg: np.ndarray


def rpe(gt_poses: np.ndarray, est_poses: np.ndarray, delta: int = 1) -> RPEResult:
    """Relative pose error at frame spacing `delta` between (N, 4, 4) streams."""
    gt = torch.as_tensor(np.asarray(gt_poses), dtype=torch.float32)
    es = torch.as_tensor(np.asarray(est_poses), dtype=torch.float32)
    gt_rel = se3.inverse(gt[:-delta]) @ gt[delta:]
    es_rel = se3.inverse(es[:-delta]) @ es[delta:]
    err = se3.inverse(gt_rel) @ es_rel
    t_err = torch.linalg.vector_norm(se3.translation(err), dim=-1).numpy()
    r_err = np.degrees(np.linalg.norm(se3.so3_log(se3.rotation(err)).numpy(), axis=-1))
    return RPEResult(
        trans_rmse=float(np.sqrt((t_err**2).mean())),
        rot_rmse_deg=float(np.sqrt((r_err**2).mean())),
        trans_errors=t_err,
        rot_errors_deg=r_err,
    )


def per_axis_stats(poses: np.ndarray, axes: str = "sxyz") -> dict[str, np.ndarray]:
    """Per-axis std/mean of the translations and euler angles of (N, 4, 4)
    poses, computed in float32 as the reference's jnp arrays are."""
    P = torch.as_tensor(np.asarray(poses), dtype=torch.float32)
    t = se3.translation(P).numpy()
    e = se3.rotmat_to_euler(se3.rotation(P), axes=axes).numpy()
    return {
        "translation_std": t.std(axis=0),
        "translation_mean": t.mean(axis=0),
        "euler_std": e.std(axis=0),
        "euler_mean": e.mean(axis=0),
    }


def gt_vo_difference(gt_poses: np.ndarray, vo_poses: np.ndarray) -> dict[str, np.ndarray]:
    """Per-frame GT-vs-VO deltas of (N, 4, 4) streams: translation_diff
    (N, 3) gt_t - vo_t in float64, euler_diff (N, 3) gt - vo 'sxyz' angles
    (float32 angles, the delta wrapped into [-pi, pi)) and euclidean (N,)
    ||gt_t - vo_t||."""
    gt_poses = np.asarray(gt_poses, np.float64)
    vo_poses = np.asarray(vo_poses, np.float64)
    if gt_poses.shape != vo_poses.shape or gt_poses.shape[1:] != (4, 4):
        raise ValueError(f"gt_vo_difference: shapes {gt_poses.shape} and {vo_poses.shape}")
    t_diff = gt_poses[:, :3, 3] - vo_poses[:, :3, 3]
    euler = lambda P: se3.rotmat_to_euler(torch.as_tensor(P[:, :3, :3], dtype=torch.float32)).numpy()
    e_diff = euler(gt_poses) - euler(vo_poses)
    e_diff = (e_diff + np.pi) % (2.0 * np.pi) - np.pi
    return {
        "translation_diff": t_diff,
        "euler_diff": e_diff,
        "euclidean": np.linalg.norm(t_diff, axis=1),
    }
