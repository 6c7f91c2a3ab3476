"""Distributed windowed bundle adjustment over a mesh of ranks — port of
droplet_visual_odometry_tpu/parallel/distributed_ba.py.

  * LANDMARKS are the sharded axis: each rank owns L/D landmarks with their
    observation columns. Landmark blocks (Hll, bl, dx) never leave their
    device.
  * Keyframe poses are replicated (a window is small). Each rank forms its
    partial reduced-camera terms (Hcc, bc, S_off = sum_l Hcl Hll^-1 Hlc,
    rhs_corr = sum_l Hcl Hll^-1 bl) over its landmarks; they are summed
    over the mesh and the reduced (6W x 6W) solve is replicated on every
    rank.
  * The reference issues four camera-side psums a step and two for each
    cost. Here the four partial terms are packed into one flat buffer and
    summed by one all_reduce a step, and the cost's sum and count by one
    more: the sum is elementwise, so the numbers are the same, and each
    rendezvous is a fixed cost on gloo.
  * Accept and reject stay on the device (torch.where): no host read inside
    the loop, so every rank issues the same collectives in the same order.

The per-shard math is backend/ba.py's (normal blocks, landmark elimination,
camera solve, back-substitution), so single-device and distributed BA share
one implementation of the physics.
"""

from __future__ import annotations

import torch

from droplet_visual_odometry_tpu_torch.backend import ba
from droplet_visual_odometry_tpu_torch.core import se3
from droplet_visual_odometry_tpu_torch.parallel.sharding import Mesh, all_gather_rows, local_shard, psum


def _pad_landmarks(window: ba.BAWindow, n_devices: int) -> ba.BAWindow:
    """Pad L to a multiple of n_devices with unobserved landmarks at the origin."""
    L = window.points.shape[0]
    pad = (-L) % n_devices
    if pad == 0:
        return window
    zeros = lambda t, shape: torch.zeros(shape, dtype=t.dtype, device=t.device)
    W = window.obs_uv.shape[0]
    return ba.BAWindow(
        poses=window.poses,
        points=torch.cat([window.points, zeros(window.points, (pad, 3))]),
        obs_uv=torch.cat([window.obs_uv, zeros(window.obs_uv, (W, pad, 2))], dim=1),
        obs_mask=torch.cat([window.obs_mask, zeros(window.obs_mask, (W, pad))], dim=1),
        K=window.K,
    )


def run_ba_distributed(mesh: Mesh, window: ba.BAWindow, cfg: ba.BAConfig = ba.BAConfig()) -> ba.BAResult:
    """LM windowed BA with the landmarks sharded over the mesh. Takes the
    full window on every rank; returns replicated poses, costs and RMS, and
    the padded (L', 3) points gathered from every rank."""
    window = _pad_landmarks(window, mesh.size)
    dev = mesh.device
    poses, K = window.poses.to(dev), window.K.to(dev)
    points = local_shard(mesh, window.points, 0)
    obs_uv = local_shard(mesh, window.obs_uv, 1)
    obs_mask = local_shard(mesh, window.obs_mask, 1)
    local = ba.BAWindow(poses, points, obs_uv, obs_mask, K)
    huber, min_depth = cfg.huber_px, cfg.min_depth

    def total_cost(poses, points):
        """Mean robust squared reprojection error over all shards."""
        p, uv = ba._project(poses, points, K)
        r = uv - obs_uv
        r2 = torch.sum(r * r, dim=-1)
        valid = obs_mask & (p[..., 2] > min_depth)
        rn = torch.sqrt(torch.clamp(r2, min=1e-12))
        wgt = torch.where(rn <= huber, 1.0, huber / rn) * valid
        c, n = psum(mesh, torch.stack([torch.sum(wgt * r2), torch.sum(valid).to(r2.dtype)]))
        return c / torch.clamp(n, min=1.0)

    cost0 = total_cost(poses, points)
    cost = cost0
    lam = torch.full((), cfg.init_lambda, dtype=poses.dtype, device=dev)
    Wn = poses.shape[0]
    sizes = [Wn * 36, Wn * 6, Wn * Wn * 36, Wn * 6]
    for _ in range(cfg.iters):
        Hcc, Hll, Hcl, bc, bl = ba._build_normal_blocks(local, poses, points, huber, min_depth)
        Hll_inv, S_off, rhs_corr = ba._eliminate_landmarks(Hll, Hcl, bl, lam)
        flat = psum(mesh, torch.cat([t.reshape(-1) for t in (Hcc, bc, S_off, rhs_corr)]))
        Hcc, bc, S_off, rhs_corr = (
            t.reshape(s) for t, s in zip(torch.split(flat, sizes), (Hcc.shape, bc.shape, S_off.shape, rhs_corr.shape))
        )
        dc = ba._solve_cameras(Hcc, bc, S_off, rhs_corr, lam, cfg.n_fixed)
        dx = ba._back_substitute(Hcl, Hll_inv, bl, dc)

        new_poses = se3.se3_exp(dc) @ poses
        new_points = points + dx
        new_cost = total_cost(new_poses, new_points)
        ok = (new_cost < cost) & torch.isfinite(new_cost)
        poses = torch.where(ok, new_poses, poses)
        points = torch.where(ok, new_points, points)
        lam = torch.clamp(torch.where(ok, lam * cfg.lambda_down, lam * cfg.lambda_up), 1e-9, 1e6)
        cost = torch.where(ok, new_cost, cost)

    # Final unweighted RMS over the valid observations of every shard.
    p, uv = ba._project(poses, points, K)
    r = uv - obs_uv
    valid = obs_mask & (p[..., 2] > min_depth)
    sq, n = psum(mesh, torch.stack([torch.sum(torch.where(valid, torch.sum(r * r, -1), 0.0)),
                                    torch.sum(valid).to(r.dtype)]))
    rms = torch.sqrt(sq / torch.clamp(n, min=1.0))
    return ba.BAResult(poses=poses, points=all_gather_rows(mesh, points), initial_cost=cost0, final_cost=cost,
                       rms_px=rms)
