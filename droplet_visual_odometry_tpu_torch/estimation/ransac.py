"""Batched essential-matrix LO-RANSAC — port of droplet_visual_odometry_tpu/estimation/ransac.py.

Every pair of a sequence is estimated at once: the pair dimension P leads
every tensor, and each pair samples B 8-point hypotheses, scores them with
one batched Sampson error, runs the LO round and the full-set polish, and
projects the winner to the essential manifold — the reference's schedule,
with both `fused_lo_polish` branches.

Random draws: the reference draws threefry uniforms (ransac.py:88 and :188);
here they come from a torch.Generator, or are injected — `u_hyp` (P, B*8)
for the hypothesis draw and `u_lo` (P, 128*14) for the LO draw ((P, 2,
128*14) for the two sequential LO rounds) — so tests can replay the
reference's draws exactly.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from droplet_visual_odometry_tpu_torch.estimation import epipolar


@dataclasses.dataclass(frozen=True)
class RansacConfig:
    """Same fields and defaults as the reference's RansacConfig (see its comments)."""

    n_hypotheses: int = 384
    sample_size: int = 8
    threshold_px: float = 1.0
    refine_iters: int = 2
    lo_hypotheses: int = 128
    lo_sample_size: int = 14
    hyp_eig_iters: int = 3
    lo_eig_iters: int = 3
    fused_lo_polish: bool = True


class RansacResult(NamedTuple):
    E: torch.Tensor  # (P, 3, 3) best essential matrix
    inliers: torch.Tensor  # (P, N) bool
    n_inliers: torch.Tensor  # (P,) int32
    best_score: torch.Tensor  # (P,) float32 final MSAC cost (lower is better)


def _sample_indices(u: torch.Tensor, n_hyp: int, sample_size: int, valid: torch.Tensor) -> torch.Tensor:
    """(P, n_hyp, sample_size) indices drawn uniformly, with replacement, from
    each pair's valid points, given (P, n_hyp*sample_size) uniforms in [0, 1).

    Packed index table + (u * n_valid) in float32 truncated to int, clamped
    at n_valid - 1 — the reference's arithmetic exactly."""
    p, n = valid.shape
    v = valid.to(torch.int64)
    pos = torch.cumsum(v, dim=-1) - 1
    n_valid = torch.clamp(pos[:, -1:] + 1, min=1)  # (P, 1)
    slot = torch.where(v > 0, pos, torch.full_like(pos, n))
    src = torch.arange(n, device=valid.device).expand(p, n)
    table = torch.zeros((p, n + 1), dtype=torch.int64, device=valid.device).scatter(1, slot, src)[:, :n]
    draw = torch.minimum((u * n_valid.to(torch.float32)).to(torch.int64), n_valid - 1)
    return torch.gather(table, 1, draw).reshape(p, n_hyp, sample_size)


def _take_points(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(P, N, 3) points, (P, B, S) indices -> (P, B, S, 3)."""
    p = x.shape[0]
    return x[torch.arange(p, device=x.device)[:, None, None], idx]


def _pick(t: torch.Tensor, best: torch.Tensor) -> torch.Tensor:
    """Select candidate `best[p]` along dim 1 of (P, C, ...)."""
    return t[torch.arange(t.shape[0], device=t.device), best]


def ransac_essential(
    pts1_px: torch.Tensor,
    pts2_px: torch.Tensor,
    valid: torch.Tensor,
    K: torch.Tensor,
    cfg: RansacConfig = RansacConfig(),
    generator: torch.Generator | None = None,
    u_hyp: torch.Tensor | None = None,
    u_lo: torch.Tensor | None = None,
) -> RansacResult:
    """Robust E for each of P pairs of (N, 2) matched pixel coords with (N,) masks."""
    dev = pts1_px.device
    p, n = valid.shape
    x1 = epipolar.to_normalized(pts1_px, K)
    x2 = epipolar.to_normalized(pts2_px, K)
    f = 0.5 * (K[0, 0] + K[1, 1])
    thr2 = (cfg.threshold_px / f) ** 2

    n_lo_rounds = 1 if cfg.fused_lo_polish else 2
    if u_hyp is None:
        u_hyp = torch.rand((p, cfg.n_hypotheses * cfg.sample_size), generator=generator, device=dev)
    if cfg.lo_hypotheses > 0:
        if u_lo is None:
            u_lo = torch.rand(
                (p, n_lo_rounds, cfg.lo_hypotheses * cfg.lo_sample_size), generator=generator, device=dev
            )
        elif u_lo.dim() == 2:
            u_lo = u_lo[:, None]

    # One global Hartley frame per pair conditions every minimal solve.
    vw = valid.to(torch.float32)
    x1g, T1 = epipolar._hartley_normalize(x1, vw)
    x2g, T2 = epipolar._hartley_normalize(x2, vw)

    def denorm(En):  # (P, C, 3, 3)
        return T2.transpose(-1, -2)[:, None] @ En @ T1[:, None]

    def msac_cost(err):  # (P, C, N) -> (P, C); NaN-proof truncated cost
        e = torch.where(torch.isfinite(err), err, thr2)
        return torch.sum(torch.where(valid[:, None, :], torch.minimum(e, thr2), torch.zeros_like(e)), dim=-1)

    idx = _sample_indices(u_hyp, cfg.n_hypotheses, cfg.sample_size, valid)
    Es = denorm(
        epipolar.essential_8point(
            _take_points(x1g, idx), _take_points(x2g, idx),
            torch.ones(idx.shape, dtype=torch.float32, device=dev),
            enforce_rank2=False, hartley=False, eig_iters=cfg.hyp_eig_iters,
        )
    )  # (P, B, 3, 3)
    err = epipolar.sampson_error(Es, x1, x2)  # (P, B, N)
    costs = msac_cost(err)
    best = torch.argmin(costs, dim=-1)
    E = _pick(Es, best)
    inliers = (_pick(err, best) < thr2) & valid
    cost = _pick(costs, best)

    def accept_batch(Es_c, E, inliers, cost):
        """Score candidates against the full set; accept the best if it does
        not raise the carried MSAC cost."""
        err_c = epipolar.sampson_error(Es_c, x1, x2)
        costs_c = msac_cost(err_c)
        best_c = torch.argmin(costs_c, dim=-1)
        cost_c = _pick(costs_c, best_c)
        better = cost_c <= cost
        E = torch.where(better[:, None, None], _pick(Es_c, best_c), E)
        inliers = torch.where(better[:, None], (_pick(err_c, best_c) < thr2) & valid, inliers)
        cost = torch.where(better, cost_c, cost)
        return E, inliers, cost

    def lo_candidates(u, inl, eig_iters):
        idx_lo = _sample_indices(u, cfg.lo_hypotheses, cfg.lo_sample_size, inl)
        return denorm(
            epipolar.essential_8point(
                _take_points(x1g, idx_lo), _take_points(x2g, idx_lo),
                torch.ones(idx_lo.shape, dtype=torch.float32, device=dev),
                enforce_rank2=False, hartley=False, eig_iters=eig_iters,
            )
        )

    def polish_candidate(inl):  # full-set weighted 8-point -> (P, 1, 3, 3)
        return epipolar.essential_8point(x1, x2, inl.to(torch.float32), enforce_rank2=False)[:, None]

    if cfg.fused_lo_polish and cfg.lo_hypotheses > 0:
        cands = torch.cat(
            [lo_candidates(u_lo[:, 0], inliers, cfg.lo_eig_iters), polish_candidate(inliers)], dim=1
        )
        E, inliers, cost = accept_batch(cands, E, inliers, cost)
        E, inliers, cost = accept_batch(polish_candidate(inliers), E, inliers, cost)
    else:
        if cfg.lo_hypotheses > 0:
            for r in range(2):
                E, inliers, cost = accept_batch(
                    lo_candidates(u_lo[:, r], inliers, cfg.lo_eig_iters), E, inliers, cost
                )
        for _ in range(cfg.refine_iters):
            E, inliers, cost = accept_batch(polish_candidate(inliers), E, inliers, cost)
    E = epipolar.project_to_essential(E)
    return RansacResult(
        E=E,
        inliers=inliers,
        n_inliers=torch.sum(inliers, dim=-1).to(torch.int32),
        best_score=cost.to(torch.float32),
    )


def ransac_pose(
    pts1_px: torch.Tensor,
    pts2_px: torch.Tensor,
    valid: torch.Tensor,
    K: torch.Tensor,
    cfg: RansacConfig = RansacConfig(),
    generator: torch.Generator | None = None,
    u_hyp: torch.Tensor | None = None,
    u_lo: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, RansacResult]:
    """findEssentialMat + recoverPose for P pairs: (R (P, 3, 3), t_unit (P, 3),
    result) with p_curr = R @ p_prev + t."""
    res = ransac_essential(pts1_px, pts2_px, valid, K, cfg, generator, u_hyp, u_lo)
    x1 = epipolar.to_normalized(pts1_px, K)
    x2 = epipolar.to_normalized(pts2_px, K)
    R, t, front = epipolar.recover_pose(res.E, x1, x2, res.inliers.to(torch.float32))
    return R, t, res._replace(inliers=res.inliers & front)
