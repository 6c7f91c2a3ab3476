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
