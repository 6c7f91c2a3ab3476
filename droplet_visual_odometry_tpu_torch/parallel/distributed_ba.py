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
    the loop, so every rank issues the same collectives in the same order,
    and over NCCL the loop is one captured CUDA graph (run_ba_distributed).

The per-shard math is backend/ba.py's (normal blocks, landmark elimination,
camera solve, back-substitution), so single-device and distributed BA share
one implementation of the physics.
"""

from __future__ import annotations

import functools

import torch

from droplet_visual_odometry_tpu_torch.backend import ba
from droplet_visual_odometry_tpu_torch.core import se3
from droplet_visual_odometry_tpu_torch.parallel.sharding import Mesh, all_gather_rows, local_shard, psum
from droplet_visual_odometry_tpu_torch.utils import graphs


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


def _shard_window(mesh: Mesh, window: ba.BAWindow) -> tuple:
    """The program's inputs: the window padded to a multiple of the mesh
    size in L, this rank's block of landmarks and observation columns, all
    on its device (outside the program)."""
    window = _pad_landmarks(window, mesh.size)
    dev = mesh.device
    return (window.poses.to(dev), local_shard(mesh, window.points, 0), local_shard(mesh, window.obs_uv, 1),
            local_shard(mesh, window.obs_mask, 1), window.K.to(dev))


def _ba_body(poses, points, obs_uv, obs_mask, K, *, mesh: Mesh, cfg: ba.BAConfig) -> ba.BAResult:
    """The LM loop over this rank's landmark shard with the mesh's psums,
    the final RMS and the gather of every rank's points. No host read and
    no host data inside."""
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
    lam = torch.full((), cfg.init_lambda, dtype=poses.dtype, device=poses.device)
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


def run_ba_distributed(mesh: Mesh, window: ba.BAWindow, cfg: ba.BAConfig = ba.BAConfig()) -> ba.BAResult:
    """LM windowed BA with the landmarks sharded over the mesh. Takes the
    full window on every rank; returns replicated poses, costs and RMS, and
    the padded (L', 3) points gathered from every rank.

    Over an NCCL mesh on the card the whole LM loop, the final RMS and the
    gather replay as one captured CUDA graph per (W, L'/D, BAConfig, mesh),
    their collectives inside (the reference's shard_map, no host round trip
    per iteration); the padding and the shards are staged outside it. On
    gloo or without a group it runs run_ba_distributed_eager
    (utils/graphs.py)."""
    body = functools.partial(_ba_body, mesh=mesh, cfg=cfg)
    return graphs.run("run_ba_distributed", body, _shard_window(mesh, window), cfg, mesh.device, mesh)


def run_ba_distributed_eager(mesh: Mesh, window: ba.BAWindow, cfg: ba.BAConfig = ba.BAConfig()) -> ba.BAResult:
    """run_ba_distributed op by op (the captured program's twin)."""
    return _ba_body(*_shard_window(mesh, window), mesh=mesh, cfg=cfg)
