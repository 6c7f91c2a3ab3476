#!/usr/bin/env python3
"""The "ours none" row of parity.py's marker_gap scenario (render seed 3,
scale_mode='hold') over RANSAC draws, in the PyTorch port on a CPU.

    JAX_PLATFORMS=cpu python tools/marker_gap_draws.py [--seeds 0 ... 11] [--swap-ba]

Runs the port's run_sequence on the scenario for each seed, with its
default draws: the JAX package's own per-pair draws for that seed
(split(PRNGKey(s), N-1), utils/threefry.py). Prints one JSON line per run:
the row's ATE RMSE (m), the scale the hold carries across the marker gap
(the last live pair's) and the pairs that passed.

--swap-ba: the "ours ba" row (seed 0) of the JAX package and of the port,
each backend also on the other's frame-to-frame trajectory, to tell the
backend's share of a difference from the trajectory's.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from droplet_visual_odometry_tpu_torch import parity, pipeline  # noqa: E402
from droplet_visual_odometry_tpu_torch.estimation import vo  # noqa: E402


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", type=int, nargs="*", default=list(range(12)))
    parser.add_argument("--swap-ba", action="store_true")
    opts = parser.parse_args()
    seq = parity.scenarios(quick=False)["marker_gap"][0]
    cfg = parity.ours_config("hold")
    K = pipeline.effective_K(seq).astype(np.float32)
    args = (pipeline.make_preprocessor(seq, "cpu")(seq.frames), pipeline.effective_marker_corners(seq, K),
            np.asarray(seq.marker_present), np.asarray(seq.marker_poses[0], np.float32), K,
            seq.real_marker_length, cfg)
    present, gap = np.flatnonzero(seq.marker_present), np.flatnonzero(~seq.marker_present)

    def report(seed: int, traj) -> None:
        est = traj.abs_poses.numpy().astype(np.float64)[present]
        print(json.dumps(dict(seed=seed, ate_rmse_m=parity.evaluate(seq, present, est)["ate_rmse_m"],
                              held_scale=float(traj.scales[gap[0]]), ok_pairs=int(traj.ok.sum()))), flush=True)

    for s in opts.seeds:
        report(s, vo.run_sequence(*args, seed=s))
    if opts.swap_ba:
        swap_ba(seq, present)
    return 0


def swap_ba(seq, present) -> None:
    import parity as jparity  # the repo-root harness (JAX package rows)
    from droplet_visual_odometry_tpu import pipeline as jpipeline
    from droplet_visual_odometry_tpu.estimation.vo import VOConfig, VOTrajectory

    jseq = jparity.scenarios(quick=False)["marker_gap"][0]
    run_jax = lambda: jpipeline.run_experiment(jseq, VOConfig(scale_mode="hold"), seed=0, backend="ba")
    run_port = lambda: pipeline.run_experiment(seq, parity.ours_config("hold"), seed=0, backend="ba", device="cpu")
    jres, tres = run_jax(), run_port()
    rows = {"jax vo + jax ba": jres, "port vo + port ba": tres}
    # Each backend on the other's trajectory: run_sequence replaced by the other's result.
    port_run_sequence, jax_run_sequence = pipeline.run_sequence, jpipeline.run_sequence
    try:
        pipeline.run_sequence = lambda *a, **k: vo.VOTrajectory(*(torch.as_tensor(np.asarray(x))
                                                                  for x in jres.trajectory))
        rows["jax vo + port ba"] = run_port()
        jpipeline.run_sequence = lambda *a, **k: VOTrajectory(*(np.asarray(x) for x in tres.trajectory))
        rows["port vo + jax ba"] = run_jax()
    finally:
        pipeline.run_sequence, jpipeline.run_sequence = port_run_sequence, jax_run_sequence
    for name, res in rows.items():
        info = res.backend_info
        print(json.dumps(dict(run=name, ate_rmse_m=parity.evaluate(seq, present, res.vo_abs[present])["ate_rmse_m"],
                              n_keyframes=int(info["n_keyframes"]), windows=int(info["windows"]))), flush=True)


if __name__ == "__main__":
    sys.exit(main())
