"""Loop-closure detection: keyframe retrieval + geometric verification —
port of droplet_visual_odometry_tpu/backend/loop_closure.py.

  1. RETRIEVAL, two tiers: each keyframe's set pools into one global
     descriptor (the L2-normalised mean of its +-1 expanded ORB bits, or of
     its L2-normalised SIFT/SURF vectors); all pair
     similarities are one (Nk, 256) @ (256, Nk) f32 product, and the top
     `shortlist` pairs with gap >= min_gap go on to the pairwise count of
     mutual-best matches under a Hamming gate: one `matcher.match` call over
     all shortlisted pairs (the match kernel at P = shortlist).
  2. SELECTION (host numpy, the reference's calls in the reference's order,
     since tie order decides which edges exist): greedy top counts above
     min_similarity with near-duplicate suppression, capped at
     max_candidates, then the caller's extra pairs.
  3. VERIFICATION: the batched two_frame_vo over every candidate under R
     independent restarts (P = R * n_slot pairs in one call), then per
     candidate the consensus-medoid restart and the restart dispersion.

Spans (utils/profiling): `loop.retrieval` (both tiers, with the device
interval; count `pairs` shortlisted), `loop.select` (the host selection
and the extra pairs), `loop.verify` (the verification program and its
fetch, with the device interval; counts `candidates`, `slots` (R * n_slot
pairs verified) and `accepted` (the edges returned)) and `loop.pick`
(the winning restarts, the dispersions and the inlier gates).

Random draws: verification takes the reference's own uniforms, split from
PRNGKey(seed) with `seed` 0 unless the caller says otherwise
(loop_closure.py:306; utils/threefry.py makes them bit for bit on the
features' device), or `draws(n)` -> (u_hyp (n, H*8), u_lo (n, 2, L*14)) to
replay another generator's uniforms.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, NamedTuple

import numpy as np
import torch

from droplet_visual_odometry_tpu_torch.estimation.vo import VOConfig, VOStepResult, two_frame_vo
from droplet_visual_odometry_tpu_torch.frontend import matcher
from droplet_visual_odometry_tpu_torch.frontend.orb import Features, unpack_bits_pm1
from droplet_visual_odometry_tpu_torch.utils import graphs, profiling, threefry


@dataclasses.dataclass(frozen=True)
class LoopClosureConfig:
    """Same fields and defaults as the reference's LoopClosureConfig (see its comments)."""

    min_gap: int = 8
    max_candidates: int = 8
    min_similarity: int = 60
    match_max_distance: float = 64.0
    min_inliers: int = 100
    verify_hypotheses: int = 1024
    verify_lo_hypotheses: int = 256
    verify_restarts: int = 8
    extra_min_inliers: int = 20
    suppress_radius: int = 2
    weight: float = 2.0
    shortlist: int = 64


class LoopEdges(NamedTuple):
    """Accepted edges between keyframe indices (into the keyframe list)."""

    i: np.ndarray  # (C,) int
    j: np.ndarray  # (C,) int
    rel: np.ndarray  # (C, 4, 4) measured c_j_T_c_i (VO convention), scaled
    scale_ok: np.ndarray  # (C,) bool — metric (marker) scale vs unit translation
    n_inliers: np.ndarray  # (C,)
    rot_disp_deg: np.ndarray  # (C,) max pairwise rotation angle across near-winner restarts
    dir_disp_deg: np.ndarray  # (C,) max pairwise translation-direction angle


def _pair_list(n_kf: int, min_gap: int) -> tuple[np.ndarray, np.ndarray]:
    ia, ib = np.triu_indices(n_kf, k=min_gap)
    return ia.astype(np.int32), ib.astype(np.int32)


def global_descriptors(desc: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(Nk, K, ...) descriptor sets + (Nk, K) masks -> (Nk, D) L2-normalised
    global descriptors: bag-of-bits pooling of packed ORB words (D = 256;
    the +-1 sums are integers, exact in f32), or the mean of the
    L2-normalised vectors of float SIFT/SURF sets."""
    if desc.is_floating_point():
        d = desc.to(torch.float32)
        d = d / torch.clamp(torch.linalg.vector_norm(d, dim=-1, keepdim=True), min=1e-9)
    else:
        d = unpack_bits_pm1(desc, torch.float32)  # (Nk, K, 256)
    w = valid.to(torch.float32)
    g = torch.sum(d * w[..., None], dim=1) / torch.clamp(torch.sum(w, dim=1, keepdim=True), min=1.0)
    return g / torch.clamp(torch.linalg.vector_norm(g, dim=-1, keepdim=True), min=1e-9)


def global_similarity(g: torch.Tensor) -> torch.Tensor:
    """(Nk, D) -> (Nk, Nk) cosine similarities: one f32 product (TF32 is off)."""
    return g @ g.T


def _shortlist_pairs(feats: Features, n_kf: int, min_gap: int, shortlist: int) -> tuple[np.ndarray, np.ndarray]:
    """Tier-1 retrieval: the top-`shortlist` keyframe pairs by global
    similarity among pairs with gap >= min_gap (host argpartition, as the
    reference)."""
    ia, ib = _pair_list(n_kf, min_gap)
    if shortlist <= 0 or len(ia) <= shortlist:
        return ia, ib
    sims = global_similarity(global_descriptors(feats.desc, feats.valid)).cpu().numpy()[ia, ib]
    keep = np.argpartition(-sims, shortlist - 1)[:shortlist]
    return ia[keep], ib[keep]


def _retrieval_counts(
    desc: torch.Tensor, valid: torch.Tensor, ia: np.ndarray, ib: np.ndarray, max_distance: float
) -> torch.Tensor:
    """(P,) int32 mutual-best match counts for keyframe pairs (ia, ib)."""
    a = torch.as_tensor(ia, dtype=torch.int64, device=desc.device)
    b = torch.as_tensor(ib, dtype=torch.int64, device=desc.device)
    m = matcher.match(desc[a], desc[b], valid[a], valid[b], mode="crosscheck", max_distance=max_distance)
    return torch.sum(m.valid, dim=-1).to(torch.int32)


def _select_candidates(
    ia: np.ndarray, ib: np.ndarray, counts: np.ndarray, cfg: LoopClosureConfig
) -> list[tuple[int, int]]:
    """Greedy host selection with near-duplicate suppression."""
    order = np.argsort(-counts)
    chosen: list[int] = []
    for p in order:
        if counts[p] < cfg.min_similarity or len(chosen) >= cfg.max_candidates:
            break
        if any(
            abs(int(ia[p]) - int(ia[q])) <= cfg.suppress_radius
            and abs(int(ib[p]) - int(ib[q])) <= cfg.suppress_radius
            for q in chosen
        ):
            continue
        chosen.append(int(p))
    return [(int(ia[p]), int(ib[p])) for p in chosen]


def _verify_candidates(
    feats: Features,
    corners: torch.Tensor,
    mvalid: torch.Tensor,
    K: torch.Tensor,
    real_marker_length: float,
    vo_cfg: VOConfig,
    ca: np.ndarray,
    cb: np.ndarray,
    u_hyp: torch.Tensor,
    u_lo: torch.Tensor,
) -> VOStepResult:
    """two_frame_vo over the candidate pairs (ca[p], cb[p]), batched in one
    call, on the RANSAC uniforms u_hyp (P, H*8) and u_lo (P, 2, L*14). The
    pairs' features, corners and marker flags are gathered first; on a CUDA
    device two_frame_vo then replays one captured CUDA graph per (P, K,
    VOConfig) (the reference's jitted _verify_candidates), elsewhere it runs
    eagerly."""
    inputs = _verify_inputs(feats, corners, mvalid, K, ca, cb, u_hyp, u_lo)
    body = functools.partial(_verify_body, vo_cfg=vo_cfg, real_marker_length=float(real_marker_length))
    return graphs.run("verify", body, inputs, (vo_cfg, float(real_marker_length)), corners.device)


def _verify_candidates_eager(
    feats: Features,
    corners: torch.Tensor,
    mvalid: torch.Tensor,
    K: torch.Tensor,
    real_marker_length: float,
    vo_cfg: VOConfig,
    ca: np.ndarray,
    cb: np.ndarray,
    u_hyp: torch.Tensor,
    u_lo: torch.Tensor,
) -> VOStepResult:
    """_verify_candidates op by op on any device: the captured program's twin."""
    inputs = _verify_inputs(feats, corners, mvalid, K, ca, cb, u_hyp, u_lo)
    return _verify_body(*inputs, vo_cfg=vo_cfg, real_marker_length=float(real_marker_length))


def _verify_inputs(feats, corners, mvalid, K, ca, cb, u_hyp, u_lo) -> tuple:
    """The verification program's inputs: both sides' features (5 + 5
    tensors), corners (P, 4, 2) x2, the pairs' marker flags (P,), K, the
    uniforms."""
    a = torch.as_tensor(ca, dtype=torch.int64, device=corners.device)
    b = torch.as_tensor(cb, dtype=torch.int64, device=corners.device)
    return (*(t[a] for t in feats), *(t[b] for t in feats), corners[a], corners[b], mvalid[a] & mvalid[b],
            K, u_hyp, u_lo)


def _verify_body(*tensors, vo_cfg: VOConfig, real_marker_length: float) -> VOStepResult:
    fa, fb = Features(*tensors[:5]), Features(*tensors[5:10])
    corners_a, corners_b, mv, K, u_hyp, u_lo = tensors[10:]
    return two_frame_vo(fa, fb, corners_a, corners_b, mv, K, real_marker_length, vo_cfg, u_hyp, u_lo)


@functools.lru_cache(maxsize=16)
def reference_draws(n: int, ransac_cfg, seed: int = 0, device="cpu") -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's verification uniforms for n (restart, slot) pairs:
    split(PRNGKey(seed), n), one uniform draw per key for the hypotheses and
    fold_in(key, 1) / (key, 2) for the two LO rounds (loop_closure.py:306,
    ransac.py:88, 203-206). Returns (u_hyp (n, H*8), u_lo (n, 2, L*14)).
    They are a constant of (n, ransac_cfg, seed, device), so they are made
    once (some hundred element-wise launches) and kept; callers must not
    write into them. Both LO rounds are drawn whatever fused_lo_polish says."""
    keys = threefry.split(threefry.prng_key(seed, device), n)
    return threefry.ransac_uniforms(keys, dataclasses.replace(ransac_cfg, fused_lo_polish=False))


def verify_slots(n_candidates: int, cfg: LoopClosureConfig) -> int:
    """Candidate slots per restart: max_candidates, doubled until every
    candidate fits (extra pairs may exceed the cap)."""
    n_slot = cfg.max_candidates
    while n_slot < n_candidates:
        n_slot *= 2
    return n_slot


def _pick_restarts(res: VOStepResult, R: int, n_slot: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per slot, from (R, n_slot) numpy restart results: (winning restart,
    rotation dispersion deg, direction dispersion deg). Only ok restarts win,
    ties prefer metric scale; with R >= 2 the winner is the consensus medoid
    of the restarts within 85% of the slot's best inlier count, and the
    dispersion is their max pairwise disagreement (180 deg when fewer than
    two qualify)."""
    ok_r = np.asarray(res.ok)
    inl_r = np.asarray(res.n_inliers, np.int64)
    score = np.where(ok_r, inl_r * 2 + np.asarray(res.scale_ok, np.int64), -1)
    best_r = np.argmax(score, axis=0)
    Rm = np.asarray(res.rel_unit, np.float64)[..., :3, :3]
    tm = np.asarray(res.rel_unit, np.float64)[..., :3, 3]
    tm = tm / np.maximum(np.linalg.norm(tm, axis=-1, keepdims=True), 1e-12)
    rot_disp = np.zeros(n_slot)
    dir_disp = np.zeros(n_slot)
    if R >= 2:
        for s in range(n_slot):
            kk = np.flatnonzero(ok_r[:, s])
            if len(kk) >= 2:
                bar = 0.85 * inl_r[kk, s].max()
                kk = kk[inl_r[kk, s] >= bar]
            if len(kk) < 2:
                rot_disp[s], dir_disp[s] = 180.0, 180.0
                continue
            n = len(kk)
            rot_pair = np.zeros((n, n))
            dir_pair = np.zeros((n, n))
            for x in range(n):
                for y in range(x + 1, n):
                    a, b = kk[x], kk[y]
                    tr = np.trace(Rm[a, s] @ Rm[b, s].T)
                    ang = np.degrees(np.arccos(np.clip((tr - 1) / 2, -1, 1)))
                    rot_pair[x, y] = rot_pair[y, x] = ang
                    c = np.clip(tm[a, s] @ tm[b, s], -1, 1)
                    da = np.degrees(np.arccos(c))
                    dir_pair[x, y] = dir_pair[y, x] = da
            iu = np.triu_indices(n, 1)
            rot_disp[s] = float(rot_pair[iu].max())
            dir_disp[s] = float(dir_pair[iu].max())
            tot = rot_pair.sum(axis=1) + dir_pair.sum(axis=1) / 8.0
            order = np.lexsort((-inl_r[kk, s], tot))
            best_r[s] = kk[order[0]]
    return best_r, rot_disp, dir_disp


def _verify_vo_config(vo_cfg: VOConfig, cfg: LoopClosureConfig) -> VOConfig:
    """Verification's RANSAC: at least the loop budget of hypotheses, and two
    sequential LO rounds (wide-baseline pairs need the second)."""
    return dataclasses.replace(
        vo_cfg,
        ransac=dataclasses.replace(
            vo_cfg.ransac,
            n_hypotheses=max(vo_cfg.ransac.n_hypotheses, cfg.verify_hypotheses),
            lo_hypotheses=max(vo_cfg.ransac.lo_hypotheses, cfg.verify_lo_hypotheses),
            fused_lo_polish=False,
        ),
    )


def _candidate_pairs(
    feats: Features, n_kf: int, cfg: LoopClosureConfig, extra_pairs: tuple[np.ndarray, np.ndarray] | None
) -> tuple[np.ndarray, np.ndarray, int]:
    """(ca, cb, n_retrieved): the retrieved candidates (shortlist, counts,
    greedy selection; none below min_gap + 2 keyframes), then the caller's
    extra pairs not already chosen."""
    chosen_pairs: list[tuple[int, int]] = []
    counts = None
    if n_kf >= cfg.min_gap + 2:
        with profiling.span("loop.retrieval", device=feats.desc.device) as rec:
            ia, ib = _shortlist_pairs(feats, n_kf, cfg.min_gap, cfg.shortlist)
            counts = _retrieval_counts(feats.desc, feats.valid, ia, ib, cfg.match_max_distance).cpu().numpy()
            rec.set(pairs=len(ia))
    with profiling.span("loop.select"):
        if counts is not None:
            chosen_pairs = _select_candidates(ia, ib, counts, cfg)
        n_retrieved = len(chosen_pairs)
        if extra_pairs is not None:
            seen = set(chosen_pairs)
            for a, b in zip(*extra_pairs):
                pair = (int(a), int(b))
                if pair not in seen and 0 <= pair[0] < pair[1] < n_kf:
                    chosen_pairs.append(pair)
                    seen.add(pair)
        ca = np.asarray([p[0] for p in chosen_pairs], np.int32)
        cb = np.asarray([p[1] for p in chosen_pairs], np.int32)
    return ca, cb, n_retrieved


def _restart_layout(ca: np.ndarray, cb: np.ndarray, n_slot: int, R: int) -> tuple[np.ndarray, np.ndarray]:
    """(R * n_slot,) verification pairs: the candidates padded to n_slot by
    repeating candidate 0, tiled once per restart."""
    pad = n_slot - len(ca)
    return (np.tile(np.concatenate([ca, np.full(pad, ca[0], ca.dtype)]), R),
            np.tile(np.concatenate([cb, np.full(pad, cb[0], cb.dtype)]), R))


def find_loop_closures(
    feats: Features,  # batched over keyframes: leading axis Nk
    kf_abs: np.ndarray,  # (Nk, 4, 4) current keyframe absolute poses (cTm)
    kf_corners: np.ndarray,  # (Nk, 4, 2) marker corners (NaN where absent)
    kf_marker_present: np.ndarray,  # (Nk,)
    K,
    real_marker_length: float,
    vo_cfg: VOConfig,
    cfg: LoopClosureConfig = LoopClosureConfig(),
    seed: int = 0,
    extra_pairs: tuple[np.ndarray, np.ndarray] | None = None,
    draws: Callable[[int], tuple[torch.Tensor, torch.Tensor]] | None = None,
) -> LoopEdges:
    """Retrieval -> selection -> geometric verification, on the features'
    device. Returns the accepted edges.

    extra_pairs: keyframe index pairs sent straight to verification,
    bypassing retrieval and min_gap (marker-gap bridges, refine.py); they
    must pass the lower extra_min_inliers gate to become edges.
    """
    vo_cfg = _verify_vo_config(vo_cfg, cfg)
    dev = feats.desc.device
    n_kf = int(kf_abs.shape[0])
    empty = LoopEdges(
        i=np.zeros(0, np.int64),
        j=np.zeros(0, np.int64),
        rel=np.zeros((0, 4, 4)),
        scale_ok=np.zeros(0, bool),
        n_inliers=np.zeros(0, np.int64),
        rot_disp_deg=np.zeros(0),
        dir_disp_deg=np.zeros(0),
    )
    ca, cb, n_retrieved = _candidate_pairs(feats, n_kf, cfg, extra_pairs)
    if len(ca) == 0:
        return empty
    min_inl = np.where(np.arange(len(ca)) < n_retrieved, cfg.min_inliers, cfg.extra_min_inliers)

    # Verification over (R, n_slot) flattened: each candidate under R
    # restarts (padded slots are dropped below).
    n_c = len(ca)
    n_slot = verify_slots(n_c, cfg)
    R = max(1, cfg.verify_restarts)
    with profiling.span("loop.verify", device=dev, candidates=n_c, slots=R * n_slot) as verify:
        corners = torch.nan_to_num(torch.as_tensor(np.asarray(kf_corners), dtype=torch.float32, device=dev))
        mvalid = torch.as_tensor(np.asarray(kf_marker_present), dtype=torch.bool, device=dev)
        Kt = torch.as_tensor(np.asarray(K), dtype=torch.float32, device=dev)
        ca_p, cb_p = _restart_layout(ca, cb, n_slot, R)
        if draws is None:
            draws = lambda n: reference_draws(n, vo_cfg.ransac, seed, dev)
        u_hyp, u_lo = (torch.as_tensor(u, dtype=torch.float32, device=dev) for u in draws(R * n_slot))
        res = _verify_candidates(feats, corners, mvalid, Kt, float(real_marker_length), vo_cfg, ca_p, cb_p,
                                 u_hyp, u_lo)
        res = VOStepResult(*(t.cpu().numpy().reshape((R, n_slot) + tuple(t.shape[1:])) for t in res))
    with profiling.span("loop.pick"):
        best_r, rot_disp, dir_disp = _pick_restarts(res, R, n_slot)
        res = VOStepResult(*(a[best_r, np.arange(n_slot)][:n_c] for a in res))
        rot_disp, dir_disp = rot_disp[:n_c], dir_disp[:n_c]
        ok = res.ok & (res.n_inliers >= min_inl)
    verify.set(accepted=int(ok.sum()))
    if not ok.any():
        return empty
    rel = np.asarray(res.rel, np.float64)[ok]
    rel_unit = np.asarray(res.rel_unit, np.float64)[ok]
    scale_ok = res.scale_ok[ok]
    # Scale-free edges keep the unit-translation pose: the pose graph gives
    # them information only across the measured direction.
    rel[~scale_ok] = rel_unit[~scale_ok]
    return LoopEdges(
        i=ca[ok].astype(np.int64),
        j=cb[ok].astype(np.int64),
        rel=rel,
        scale_ok=scale_ok,
        n_inliers=res.n_inliers[ok].astype(np.int64),
        rot_disp_deg=rot_disp[ok],
        dir_disp_deg=dir_disp[ok],
    )
