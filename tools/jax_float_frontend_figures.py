#!/usr/bin/env python3
"""Reference figures of the JAX package's float-descriptor frontends (SIFT
and SURF) on PARITY.md's `clean` scenario, which chip_smoke.py drives
through the PyTorch port.

    JAX_PLATFORMS=cpu python tools/jax_float_frontend_figures.py [--seeds 0 1 2 3] [--frontends sift surf]

Renders parity.py's `clean` scenario (60 frames at 640x480, the default
SyntheticConfig otherwise) and runs the JAX package's
run_experiment(backend="none") with VOConfig(frontend=m, match_mode="ratio",
dog_threshold=0.5), the configuration of parity.py's "ours sift" and "ours
surf" rows, once per frontend and RANSAC seed. Prints one JSON line per
frontend and seed: the ATE RMSE, the pairs that passed and the per-pair
ratio-match counts (no random draw comes before matching, so the counts are
the same for every seed).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from droplet_visual_odometry_tpu import pipeline  # noqa: E402
from droplet_visual_odometry_tpu.data import synthetic  # noqa: E402
from droplet_visual_odometry_tpu.estimation.vo import VOConfig  # noqa: E402

# parity.py:scenarios()["clean"].
CLEAN_SEQ_CONFIG = dict(n_frames=60, width=640, height=480)


def float_config(frontend: str) -> VOConfig:
    """parity.py:run_ours's configuration of the float-descriptor rows."""
    return VOConfig(frontend=frontend, match_mode="ratio", dog_threshold=0.5)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    parser.add_argument("--frontends", nargs="+", default=["sift", "surf"], choices=("sift", "surf"))
    opts = parser.parse_args()
    seq = synthetic.render_sequence(synthetic.SyntheticConfig(**CLEAN_SEQ_CONFIG))
    for frontend in opts.frontends:
        for seed in opts.seeds:
            t0 = time.perf_counter()
            res = pipeline.run_experiment(seq, float_config(frontend), seed=seed, backend="none")
            traj = res.trajectory
            print(json.dumps(dict(
                frontend=frontend, seed=seed, n_frames=len(seq),
                ate_rmse=float(res.ate.rmse),
                ok_fraction=float(np.mean(np.asarray(traj.ok))),
                n_matches=[int(v) for v in np.asarray(traj.n_matches)],
                seconds=time.perf_counter() - t0,
            )), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
