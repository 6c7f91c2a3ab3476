"""Windowed bundle adjustment: Levenberg-Marquardt with a Schur complement —
port of droplet_visual_odometry_tpu/backend/ba.py.

A window holds W keyframe poses (cTw) and L landmarks with a dense (W, L)
observation grid and mask. Analytic Jacobians; the normal-equation blocks
are batched einsums; the landmark blocks Hll are inverted by the unrolled
3x3 Cholesky of ops/linalg.py and the reduced camera system (6W x 6W) is
solved densely. The first n_fixed poses are held (gauge). Accept and reject
are branchless (torch.where) for all cfg.iters steps, so run_ba reads
nothing back to the host inside its loop. On the card a float64 window
(refine.BA_DTYPE) runs the whole loop in one launch of the kernel
csrc/windowed_ba.cu (ops/cuda_ba.py), whose plain twin is run_ba_eager;
a window the kernel does not take is one captured CUDA graph of
run_ba_eager (utils/graphs.py).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from droplet_visual_odometry_tpu_torch.core import se3
from droplet_visual_odometry_tpu_torch.ops import cuda_ba, linalg
from droplet_visual_odometry_tpu_torch.utils import graphs


@dataclasses.dataclass(frozen=True)
class BAConfig:
    """Same fields and defaults as the reference's BAConfig (see its comments)."""

    iters: int = 10
    init_lambda: float = 1e-3
    lambda_up: float = 10.0
    lambda_down: float = 0.3
    huber_px: float = 2.0  # robust kernel width in pixels
    min_depth: float = 1e-3
    n_fixed: int = 1  # poses held at the head of the window (2 also pins the monocular scale)


class BAWindow(NamedTuple):
    """One BA problem."""

    poses: torch.Tensor  # (W, 4, 4) cTw keyframe poses
    points: torch.Tensor  # (L, 3) landmarks in the world frame
    obs_uv: torch.Tensor  # (W, L, 2) pixel observations
    obs_mask: torch.Tensor  # (W, L) bool
    K: torch.Tensor  # (3, 3)


class BAResult(NamedTuple):
    poses: torch.Tensor  # (W, 4, 4) optimised
    points: torch.Tensor  # (L, 3) optimised
    initial_cost: torch.Tensor  # () mean robust squared reprojection error (px^2)
    final_cost: torch.Tensor
    rms_px: torch.Tensor  # () final RMS reprojection error over the weighted observations


def _project(poses: torch.Tensor, points: torch.Tensor, K: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(W, 4, 4) x (L, 3) -> camera points (W, L, 3) and pixels (W, L, 2)."""
    p = torch.einsum("wij,lj->wli", poses[:, :3, :3], points) + poses[:, None, :3, 3]
    z = torch.clamp(p[..., 2], min=1e-6)
    u = K[0, 0] * p[..., 0] / z + K[0, 2]
    v = K[1, 1] * p[..., 1] / z + K[1, 2]
    return p, torch.stack([u, v], dim=-1)


def reprojection_cost(w: BAWindow, poses, points, huber_px: float, min_depth: float):
    """(mean robust cost, per-observation residual (W, L, 2), weights (W, L))."""
    p, uv = _project(poses, points, w.K)
    r = uv - w.obs_uv
    r2 = torch.sum(r * r, dim=-1)
    valid = w.obs_mask & (p[..., 2] > min_depth)
    # Huber: weight 1 for |r| <= delta, delta/|r| beyond.
    rn = torch.sqrt(torch.clamp(r2, min=1e-12))
    wgt = torch.where(rn <= huber_px, 1.0, huber_px / rn) * valid
    cost = torch.sum(wgt * r2) / torch.clamp(torch.sum(valid).to(r2.dtype), min=1.0)
    return cost, r, wgt


def _build_normal_blocks(w: BAWindow, poses, points, huber_px: float, min_depth: float):
    """Jacobian blocks and gradient pieces of one Gauss-Newton step:
    Hcc (W, 6, 6), Hll (L, 3, 3), Hcl (W, L, 6, 3), bc (W, 6), bl (L, 3)."""
    R = poses[:, :3, :3]
    p, uv = _project(poses, points, w.K)
    r = uv - w.obs_uv
    z = torch.clamp(p[..., 2], min=1e-6)
    valid = w.obs_mask & (p[..., 2] > min_depth)
    rn = torch.linalg.vector_norm(r, dim=-1)
    wgt = torch.where(rn <= huber_px, 1.0, huber_px / torch.clamp(rn, min=1e-12)) * valid

    fx, fy = w.K[0, 0], w.K[1, 1]
    zero = torch.zeros_like(z)
    # du/dp, dv/dp: (W, L, 2, 3)
    J_p = torch.stack(
        [
            torch.stack([fx / z, zero, -fx * p[..., 0] / (z * z)], dim=-1),
            torch.stack([zero, fy / z, -fy * p[..., 1] / (z * z)], dim=-1),
        ],
        dim=-2,
    )
    # dp/dtwist = [I | -hat(p)] (left-multiplicative [v, w] twist)
    hat_p = se3._hat(p)
    I3 = torch.eye(3, dtype=p.dtype, device=p.device).expand(hat_p.shape)
    dp_dxi = torch.cat([I3, -hat_p], dim=-1)  # (W, L, 3, 6)
    J_pose = torch.einsum("wlij,wljk->wlik", J_p, dp_dxi)  # (W, L, 2, 6)
    J_land = torch.einsum("wlij,wjk->wlik", J_p, R)  # (W, L, 2, 3)

    Wr = wgt[..., None] * r
    Hcc = torch.einsum("wlik,wl,wlim->wkm", J_pose, wgt, J_pose)
    Hll = torch.einsum("wlik,wl,wlim->lkm", J_land, wgt, J_land)
    Hcl = torch.einsum("wlik,wl,wlim->wlkm", J_pose, wgt, J_land)
    bc = -torch.einsum("wlik,wli->wk", J_pose, Wr)
    bl = -torch.einsum("wlik,wli->lk", J_land, Wr)
    return Hcc, Hll, Hcl, bc, bl


def _eliminate_landmarks(Hll, Hcl, bl, lam):
    """The landmark side of the damped Schur complement: Hll^-1 (L, 3, 3)
    by the unrolled Cholesky, and the sums over landmarks that reduce the
    camera system, S_off = sum_l Hcl Hll^-1 Hlc (W, W, 6, 6) and
    rhs_corr = sum_l Hcl Hll^-1 bl (W, 6). Sums over landmarks add up
    across landmark shards (parallel/distributed_ba.py)."""
    L = Hcl.shape[1]
    I3 = torch.eye(3, dtype=Hll.dtype, device=Hll.device)
    # LM damping, scaled by the diagonal.
    Hll_d = Hll + lam * I3 * torch.clamp(torch.diagonal(Hll, dim1=-2, dim2=-1), min=1e-6)[..., None] * I3
    # Hll^-1 by the unrolled Cholesky, solved against the columns of I.
    Lc = linalg.cholesky_unrolled(Hll_d, eps=1e-9)
    Hll_inv = torch.stack([linalg.cholesky_solve(Lc, I3[i].expand(L, 3)) for i in range(3)], dim=-1)
    HclHinv = torch.einsum("wlkm,lmn->wlkn", Hcl, Hll_inv)
    S_off = torch.einsum("wlkn,vlmn->wvkm", HclHinv, Hcl)
    rhs_corr = torch.einsum("wlkn,ln->wk", HclHinv, bl)
    return Hll_inv, S_off, rhs_corr


def _solve_cameras(Hcc, bc, S_off, rhs_corr, lam, n_fixed: int) -> torch.Tensor:
    """The reduced camera system S = delta*Hcc - S_off, rhs = bc - rhs_corr,
    gauge-fixed on the first n_fixed poses and solved densely: (W, 6)."""
    Wn = Hcc.shape[0]
    dt, dev = Hcc.dtype, Hcc.device
    I6 = torch.eye(6, dtype=dt, device=dev)
    Hcc_d = Hcc + lam * I6 * torch.clamp(torch.diagonal(Hcc, dim1=-2, dim2=-1), min=1e-6)[..., None] * I6
    S = -S_off
    diag = torch.arange(Wn, device=dev)
    S[diag, diag] += Hcc_d
    rhs = bc - rhs_corr

    if n_fixed > 0:
        # Gauge: zero the first n_fixed poses' rows and columns, identity on their diagonal blocks.
        mask = (torch.arange(Wn, device=dev) >= n_fixed).to(dt)
        S = S * mask[:, None, None, None] * mask[None, :, None, None]
        S[diag[:n_fixed], diag[:n_fixed]] = I6
        rhs = rhs * mask[:, None]

    S_dense = S.permute(0, 2, 1, 3).reshape(Wn * 6, Wn * 6)
    eye = torch.eye(Wn * 6, dtype=dt, device=dev)
    # solve_ex: no error check, so no read back to the host.
    return torch.linalg.solve_ex(S_dense + 1e-9 * eye, rhs.reshape(-1, 1))[0].reshape(Wn, 6)


def _back_substitute(Hcl, Hll_inv, bl, dc) -> torch.Tensor:
    """Landmark steps dx = Hll^-1 (bl - Hlc dc): (L, 3)."""
    Hlc_dc = torch.einsum("wlkm,wk->lm", Hcl, dc)
    return torch.einsum("lmn,ln->lm", Hll_inv, bl - Hlc_dc)


def schur_solve(Hcc, Hll, Hcl, bc, bl, lam, n_fixed: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """Solve the damped normal equations by the Schur complement on the
    landmarks. Returns (pose twists (W, 6), landmark steps (L, 3))."""
    Hll_inv, S_off, rhs_corr = _eliminate_landmarks(Hll, Hcl, bl, lam)
    dc = _solve_cameras(Hcc, bc, S_off, rhs_corr, lam, n_fixed)
    return dc, _back_substitute(Hcl, Hll_inv, bl, dc)


def _lm_step(window: BAWindow, poses, points, lam, cost, cfg: BAConfig):
    """One Levenberg-Marquardt step, accepted or rejected on the device:
    (poses, points, lam, cost) -> the same four after the step."""
    huber, min_depth = cfg.huber_px, cfg.min_depth
    Hcc, Hll, Hcl, bc, bl = _build_normal_blocks(window, poses, points, huber, min_depth)
    dc, dx = schur_solve(Hcc, Hll, Hcl, bc, bl, lam, n_fixed=cfg.n_fixed)
    new_poses = se3.se3_exp(dc) @ poses
    new_points = points + dx
    new_cost, _, _ = reprojection_cost(window, new_poses, new_points, huber, min_depth)
    ok = (new_cost < cost) & torch.isfinite(new_cost)
    return (
        torch.where(ok, new_poses, poses),
        torch.where(ok, new_points, points),
        torch.clamp(torch.where(ok, lam * cfg.lambda_down, lam * cfg.lambda_up), 1e-9, 1e6),
        torch.where(ok, new_cost, cost),
    )


def run_ba_eager(window: BAWindow, cfg: BAConfig = BAConfig()) -> BAResult:
    """Levenberg-Marquardt windowed BA op by op on the window's device (the
    captured program's twin): cfg.iters steps, each accepted or rejected on
    the device."""
    huber, min_depth = cfg.huber_px, cfg.min_depth
    cost0, _, _ = reprojection_cost(window, window.poses, window.points, huber, min_depth)
    poses, points, cost = window.poses, window.points, cost0
    lam = torch.full((), cfg.init_lambda, dtype=poses.dtype, device=poses.device)
    for _ in range(cfg.iters):
        poses, points, lam, cost = _lm_step(window, poses, points, lam, cost, cfg)
    _, r, wgt = reprojection_cost(window, poses, points, huber, min_depth)
    n = torch.clamp(torch.sum(wgt > 0), min=1)
    rms = torch.sqrt(torch.sum(torch.where(wgt > 0, torch.sum(r * r, -1), 0.0)) / n)
    return BAResult(poses=poses, points=points, initial_cost=cost0, final_cost=cost, rms_px=rms)


def runs_in_kernel(window: BAWindow) -> bool:
    """Whether run_ba takes the window to the kernel: a CUDA window of a
    dtype and shape it takes (ops/cuda_ba.fits: float64, W <= 18)."""
    W, L = window.obs_mask.shape
    return window.poses.device.type == "cuda" and cuda_ba.fits(W, L, window.poses.dtype)


def run_ba(window: BAWindow, cfg: BAConfig = BAConfig()) -> BAResult:
    """Levenberg-Marquardt windowed BA: cfg.iters steps, each accepted or
    rejected on the device. On a CUDA device, a window the kernel takes
    (`runs_in_kernel`) runs every step in one launch of csrc/windowed_ba.cu,
    summed in a fixed order (two runs give the same bits); any other CUDA
    window (float32, W > 18) replays one captured CUDA graph per (W, L,
    BAConfig), the whole LM loop (the reference's jax.jit(run_ba));
    elsewhere it runs run_ba_eager."""
    if runs_in_kernel(window):
        return BAResult(*cuda_ba.run_ba_cuda(BAWindow(*(t.contiguous() for t in window)), cfg))
    return run_ba_graph(window, cfg)


def run_ba_graph(window: BAWindow, cfg: BAConfig = BAConfig()) -> BAResult:
    """run_ba_eager as one captured CUDA graph per (W, L, BAConfig) on a CUDA
    device (utils/graphs.py), op by op elsewhere: run_ba's path for a
    window the kernel does not take."""

    def body(*tensors):
        return run_ba_eager(BAWindow(*tensors), cfg)

    return graphs.run("run_ba", body, tuple(window), cfg, window.poses.device)
