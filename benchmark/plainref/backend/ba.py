"""Windowed bundle adjustment, plain torch: Levenberg-Marquardt on the full
damped normal equations. The semantics of the port's backend/ba.run_ba,
written apart from it:

- the cost: the mean Huber-weighted squared reprojection error over the
  valid observations (in the window's mask and in front of the camera by
  more than min_depth), each observation weighted 1 within huber_px and
  huber_px / |r| beyond;
- a step: the Gauss-Newton normal equations of every free pose (a
  left-multiplied [v, w] twist) and every landmark, damped by lam times
  their diagonal (clamped below at 1e-6), solved, and taken if the cost
  falls and is finite; lam then shrinks by lambda_down, else grows by
  lambda_up, and stays in [1e-9, 1e6];
- the gauge: the first n_fixed poses are held.

Departures from the port (none changes a step in exact arithmetic):

- each step is solved on the full damped normal equations with
  torch.linalg.solve (LU), not by the Schur complement on the landmarks
  with unrolled 3x3 Cholesky inverses;
- the normal equations are summed observation by observation (each
  observation's 2x9 Jacobian, its 9x9 outer product scattered into the
  dense matrix), not by einsums over the (W, L) grid, so sums run in
  another order;
- the held poses and the landmarks with no valid observation in a step are
  left out of its system: the port's gauge rows are identity rows with a
  zero right-hand side, and such a landmark has no gradient and no
  coupling, so their steps are zero there too;
- the port's 1e-9 ridge on its reduced camera system and its Cholesky's
  1e-9 are left out.
"""

from __future__ import annotations

import dataclasses

import torch

from plainref.core import se3


@dataclasses.dataclass(frozen=True)
class BAConfig:
    """Same fields and defaults as the port's BAConfig."""

    iters: int = 10
    init_lambda: float = 1e-3
    lambda_up: float = 10.0
    lambda_down: float = 0.3
    huber_px: float = 2.0
    min_depth: float = 1e-3
    n_fixed: int = 1


def camera_points(poses: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """cTw poses (W, 4, 4) and world points (L, 3) -> camera points (W, L, 3)."""
    return points[None] @ poses[:, :3, :3].transpose(-1, -2) + poses[:, None, :3, 3]


def _pixels(pc: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    z = torch.clamp(pc[..., 2], min=1e-6)
    return torch.stack([K[0, 0] * pc[..., 0] / z + K[0, 2], K[1, 1] * pc[..., 1] / z + K[1, 2]], dim=-1)


def _huber(r: torch.Tensor, huber_px: float) -> torch.Tensor:
    rn = torch.sqrt(torch.clamp(torch.sum(r * r, dim=-1), min=1e-12))
    return torch.where(rn <= huber_px, torch.ones_like(rn), huber_px / rn)


def cost(poses, points, obs_uv, obs_mask, K, cfg: BAConfig) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(mean robust cost, residuals (W, L, 2), weights (W, L), 0 where not valid)."""
    pc = camera_points(poses, points)
    r = _pixels(pc, K) - obs_uv
    valid = obs_mask & (pc[..., 2] > cfg.min_depth)
    wgt = _huber(r, cfg.huber_px) * valid
    n = torch.clamp(torch.sum(valid).to(r.dtype), min=1.0)
    return torch.sum(wgt * torch.sum(r * r, dim=-1)) / n, r, wgt


def _hat(v: torch.Tensor) -> torch.Tensor:
    x, y, z = v.unbind(-1)
    o = torch.zeros_like(x)
    return torch.stack([torch.stack([o, -z, y], -1), torch.stack([z, o, -x], -1), torch.stack([-y, x, o], -1)], -2)


def normal_equations(poses, points, obs_uv, obs_mask, K, cfg: BAConfig):
    """The Gauss-Newton system of one step, observation by observation:
    (H (n, n), g (n,), the free poses' count, the landmarks in the system
    (their indices)). Unknowns: 6 per free pose, then 3 per landmark with a
    valid observation."""
    W = poses.shape[0]
    pc_all = camera_points(poses, points)
    valid = obs_mask & (pc_all[..., 2] > cfg.min_depth)
    wi, li = torch.nonzero(valid, as_tuple=True)
    pc = pc_all[wi, li]  # (n_obs, 3)
    r = _pixels(pc, K) - obs_uv[wi, li]
    wgt = _huber(r, cfg.huber_px)

    x, y, z = pc.unbind(-1)
    o = torch.zeros_like(z)
    fx, fy = K[0, 0], K[1, 1]
    j_proj = torch.stack([torch.stack([fx / z, o, -fx * x / (z * z)], -1),
                          torch.stack([o, fy / z, -fy * y / (z * z)], -1)], -2)  # (n_obs, 2, 3)
    eye = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(pc.shape[0], 3, 3)
    j_pose = j_proj @ torch.cat([eye, -_hat(pc)], dim=-1)  # (n_obs, 2, 6)
    j_point = j_proj @ poses[wi, :3, :3]  # (n_obs, 2, 3)
    J = torch.cat([j_pose, j_point], dim=-1)  # (n_obs, 2, 9)
    H_obs = J.transpose(-1, -2) @ (wgt[:, None, None] * J)
    g_obs = -(J.transpose(-1, -2) @ (wgt[:, None] * r)[..., None])[..., 0]

    n_free = W - cfg.n_fixed
    landmarks, rank = torch.unique(li, return_inverse=True)
    n = 6 * n_free + 3 * len(landmarks)
    six, three = torch.arange(6, device=pc.device), torch.arange(3, device=pc.device)
    pose_cols = torch.where((wi >= cfg.n_fixed)[:, None], 6 * (wi - cfg.n_fixed)[:, None] + six, n)  # n: dropped
    point_cols = 6 * n_free + 3 * rank[:, None] + three
    cols = torch.cat([pose_cols, point_cols], dim=1)  # (n_obs, 9)
    H = torch.zeros((n + 1, n + 1), dtype=pc.dtype, device=pc.device)
    H.index_put_((cols[:, :, None].expand(-1, 9, 9), cols[:, None, :].expand(-1, 9, 9)), H_obs, accumulate=True)
    g = torch.zeros(n + 1, dtype=pc.dtype, device=pc.device)
    g.index_put_((cols,), g_obs, accumulate=True)
    return H[:n, :n], g[:n], n_free, landmarks


def lm_step(poses, points, lam, cur_cost, obs_uv, obs_mask, K, cfg: BAConfig):
    """One damped step, taken or refused: (poses, points, lam, cost) after it."""
    H, g, n_free, landmarks = normal_equations(poses, points, obs_uv, obs_mask, K, cfg)
    d = torch.diagonal(H)
    step = torch.linalg.solve(H + torch.diag(lam * torch.clamp(d, min=1e-6)), g)
    new_poses = poses.clone()
    new_poses[cfg.n_fixed:] = se3.se3_exp(step[: 6 * n_free].reshape(n_free, 6)) @ poses[cfg.n_fixed:]
    new_points = points.clone()
    new_points[landmarks] = points[landmarks] + step[6 * n_free:].reshape(-1, 3)
    new_cost = cost(new_poses, new_points, obs_uv, obs_mask, K, cfg)[0]
    if bool(torch.isfinite(new_cost)) and bool(new_cost < cur_cost):
        return new_poses, new_points, torch.clamp(lam * cfg.lambda_down, 1e-9, 1e6), new_cost
    return poses, points, torch.clamp(lam * cfg.lambda_up, 1e-9, 1e6), cur_cost


def run_ba(poses, points, obs_uv, obs_mask, K, cfg: BAConfig = BAConfig()) -> dict:
    """cfg.iters Levenberg-Marquardt steps over one window: poses (W, 4, 4)
    cTw, points (L, 3), observations (W, L, 2) with mask (W, L), K (3, 3).
    Returns the optimised poses and points, the initial and final costs and
    the final RMS over the weighted observations."""
    cost0 = cost(poses, points, obs_uv, obs_mask, K, cfg)[0]
    lam = torch.tensor(cfg.init_lambda, dtype=poses.dtype, device=poses.device)  # in the window's dtype, as the port holds it
    c = cost0
    for _ in range(cfg.iters):
        poses, points, lam, c = lm_step(poses, points, lam, c, obs_uv, obs_mask, K, cfg)
    _, r, wgt = cost(poses, points, obs_uv, obs_mask, K, cfg)
    used = wgt > 0
    rms = torch.sqrt(torch.sum(torch.sum(r * r, -1)[used]) / max(int(used.sum()), 1))
    return dict(poses=poses, points=points, initial_cost=float(cost0), final_cost=float(c), rms_px=float(rms))
