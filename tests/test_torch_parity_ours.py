"""The port's parity rows against the JAX package's (CPU, quick size):
the port harness's rows of the quick clean scenario beside
parity.run_scenario's, and the
"ours none" row with the JAX package's RANSAC draws replayed.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import parity  # noqa: E402  (the repo-root harness)
from droplet_visual_odometry_tpu.data import synthetic as jsynth  # noqa: E402

from droplet_visual_odometry_tpu_torch import parity as tparity  # noqa: E402
from droplet_visual_odometry_tpu_torch.data import synthetic as tsynth  # noqa: E402
from droplet_visual_odometry_tpu_torch.estimation import vo as tvo  # noqa: E402

cv2 = pytest.importorskip("cv2")
torch.set_num_threads(2)

# parity.scenarios(quick=True)["clean"] (tests/test_torch_parity.py holds the
# port's scenarios to parity.py's byte for byte).
CLEAN_QUICK = dict(n_frames=30, width=640, height=480)
# The port draws the JAX package's samples for the seed (utils/threefry.py),
# and the two runs differ by ROADMAP C.2's divergence: XLA's jit moves the
# minimal 8-point solves, so near-tied MSAC winners reshuffle on a few pairs
# (here 5 of 29, inlier counts within 2%, relative poses within C.2's
# 1.2e-2), and the chain carries them: ATE within 1 cm (measured 6.5 mm), a
# sixth of twice the JAX package's own spread over RANSAC seeds 0-3 on this
# scenario (ATE RMSE 0.044409 / 0.023878 / 0.050708 / 0.053451 m).
REPLAYED_ATE_TOL = 1e-2
REPLAYED_REL_TOL = 1.2e-2


@pytest.fixture(scope="module")
def clean():
    return (
        jsynth.render_sequence(jsynth.SyntheticConfig(**CLEAN_QUICK)),
        tsynth.render_sequence(tsynth.SyntheticConfig(**CLEAN_QUICK)),
    )


@pytest.fixture(scope="module")
def scenario_rows(clean):
    return (
        parity.run_scenario("clean", clean[0], quick=True),
        tparity.run_all({"clean": clean[1]}, quick=True, device="cpu"),
    )


def test_run_scenario_clean_quick(clean, scenario_rows):
    """run_all (the reference chain's variants in spawned worker processes)
    gives parity.run_scenario's rows in the same order; the reference rows
    equal (the same OpenCV chain on byte-equal frames); "ours none", drawing
    the JAX package's seed-0 samples, within REPLAYED_ATE_TOL of the JAX
    package's row. parity.py's gates are not asserted here: it applies them
    only at full size (quick mode is smoke only), and on this scenario the
    JAX package's own seed-0 row, 0.044409 m, trails the best reference
    row, 0.042052 m. chip_smoke.py's phase P asserts both gates on every
    full-size scenario."""
    np.testing.assert_array_equal(clean[1].frames, clean[0].frames)
    want, (rows, walls) = scenario_rows
    assert set(rows) == {"clean"} and set(walls) == {"clean", "reference"}
    got = rows["clean"]
    assert list(got) == list(want)
    for label in want:
        if label.startswith("reference"):
            assert got[label] == want[label], label
    ours, ref = got["ours none"]["ate_rmse_m"], want["ours none"]["ate_rmse_m"]
    print(f"quick clean ours none: port {ours} JAX {ref}")
    assert abs(ours - ref) <= REPLAYED_ATE_TOL
    assert got["ours none"]["seeds"] == 1


def test_ours_none_with_replayed_draws(clean):
    """run_experiment(backend="none") on this sequence is run_sequence from
    the first marker pose (no lens, no gap): with the JAX package's per-pair
    draws for seed 0 (jax.random.split, vo.py:189) the port's row has the
    same match counts, inlier counts within 2% and relative poses within
    REPLAYED_REL_TOL of the JAX run's, and scores within REPLAYED_ATE_TOL of
    parity.run_ours's row."""
    from droplet_visual_odometry_tpu import pipeline as jpipeline

    jseq, tseq = clean
    jres = jpipeline.run_experiment(jseq, parity_config(), seed=0, backend="none")
    pres = np.flatnonzero(np.asarray(jseq.marker_present))
    want = parity.evaluate(jseq, pres, jres.vo_abs[pres])
    assert want == parity.evaluate(jseq, *parity.run_ours(jseq, backend="none", seed=0))
    keys = jax.random.split(jax.random.PRNGKey(0), len(tseq) - 1)
    u_hyp = np.stack([np.asarray(jax.random.uniform(k, (384 * 8,))) for k in keys])
    u_lo = np.stack([np.asarray(jax.random.uniform(jax.random.fold_in(k, 1), (128 * 14,))) for k in keys])
    traj = tvo.run_sequence(
        torch.from_numpy(tseq.frames).float(), tseq.marker_corners, tseq.marker_present, tseq.marker_poses[0],
        tseq.camera.K, tseq.real_marker_length, tparity.ours_config(),
        u_hyp=torch.from_numpy(u_hyp), u_lo=torch.from_numpy(u_lo),
    )
    ref = jres.trajectory
    np.testing.assert_array_equal(traj.n_matches.numpy(), np.asarray(ref.n_matches))
    ni, ni_ref = traj.n_inliers.numpy(), np.asarray(ref.n_inliers)
    print(f"replayed draws: inlier counts differ on {int((ni != ni_ref).sum())} of {len(ni)} pairs")
    assert np.all(np.abs(ni - ni_ref) <= 0.02 * ni_ref)
    np.testing.assert_allclose(traj.rel_poses.numpy(), np.asarray(ref.rel_poses), rtol=0, atol=REPLAYED_REL_TOL)
    present = np.flatnonzero(tseq.marker_present)
    np.testing.assert_array_equal(present, pres)
    got = tparity.evaluate(tseq, present, traj.abs_poses.numpy().astype(np.float64)[present])
    print(f"replayed draws: port {got} JAX {want}")
    assert abs(got["ate_rmse_m"] - want["ate_rmse_m"]) <= REPLAYED_ATE_TOL


def parity_config():
    """parity.run_ours's VOConfig of the "ours none" row on clean."""
    from droplet_visual_odometry_tpu.estimation.vo import VOConfig

    return VOConfig(scale_mode="marker")
