"""Shared inputs of the port's backend tests (test_torch_backend.py,
test_torch_loop_closure.py): a small marker-gap loop sequence, reduced
budgets for the CPU suite, and the reference's verification draws."""

import dataclasses

import numpy as np
import torch

import jax

# tests/test_loop_closure.py's loop at 448x336, cut to 32 frames, the marker
# kept on the first and last KEEP frames.
LOOP_CFG = dict(n_frames=32, width=448, height=336, n_landmarks=350, orbit_sweep=0.6, dolly=0.5, loop=True,
                noise_std=1.5)
KEEP = 6
# Reduced budgets (the defaults run in chip_smoke.py on the card).
RANSAC_KW = dict(n_hypotheses=128, lo_hypotheses=32)
LC_KW = dict(min_gap=5, min_inliers=30, max_candidates=4, verify_hypotheses=128, verify_lo_hypotheses=32,
             verify_restarts=4)
REFINE_KW = dict(n_keypoints=512)


def mask_marker_midrun(seq):
    present = seq.marker_present.copy()
    corners = seq.marker_corners.copy()
    present[KEEP:-KEEP] = False
    corners[KEEP:-KEEP] = np.nan
    return dataclasses.replace(seq, marker_present=present, marker_corners=corners)


def jax_verify_draws(n: int, n_hyp: int = LC_KW["verify_hypotheses"], n_lo: int = LC_KW["verify_lo_hypotheses"]):
    """The reference's verification uniforms for n slots: split(PRNGKey(0), n),
    uniform(key) for the hypotheses, fold_in(key, 1) and (key, 2) for the two
    LO rounds (loop_closure.py:306, ransac.py:88,203-206)."""
    keys = jax.random.split(jax.random.PRNGKey(0), n)
    u_hyp = np.stack([np.asarray(jax.random.uniform(k, (n_hyp * 8,))) for k in keys])
    u_lo = np.stack([np.stack([np.asarray(jax.random.uniform(jax.random.fold_in(k, r), (n_lo * 14,))) for r in (1, 2)])
                     for k in keys])
    return torch.from_numpy(u_hyp), torch.from_numpy(u_lo)
