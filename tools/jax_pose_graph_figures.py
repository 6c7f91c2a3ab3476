#!/usr/bin/env python3
"""Reference figures of the JAX package's pose_graph backend on the loop
sequence that chip_smoke.py drives through the PyTorch port.

    JAX_PLATFORMS=cpu python tools/jax_pose_graph_figures.py [--seeds 0 1 2 3]

Renders the 48-frame 1440x1080 out-and-back sequence (marker kept only on
the first and last 8 frames), runs the JAX package's
run_experiment(backend="pose_graph") with VOConfig(scale_mode="hold") and
the default PoseGraphRefineConfig once per RANSAC seed, and prints one JSON
line per seed: the ATE RMSE, keyframes, bridge pairs, loop edges and the
pose-graph costs. chip_smoke.py holds the port to these figures.
"""

from __future__ import annotations

import argparse
import dataclasses
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

# The sequence of chip_smoke.py's pose-graph phase (LOOP_SEQ_CONFIG there).
LOOP_SEQ_CONFIG = dict(
    n_frames=48, width=1440, height=1080, fx=1170.0, fy=1170.0, n_landmarks=900, landmark_size=0.07,
    orbit_sweep=0.6, dolly=0.5, loop=True, noise_std=1.5,
)
MARKER_KEEP = 8


def loop_sequence():
    seq = synthetic.render_sequence(synthetic.SyntheticConfig(**LOOP_SEQ_CONFIG))
    present = seq.marker_present.copy()
    corners = seq.marker_corners.copy()
    present[MARKER_KEEP:-MARKER_KEEP] = False
    corners[MARKER_KEEP:-MARKER_KEEP] = np.nan
    return dataclasses.replace(seq, marker_present=present, marker_corners=corners)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    opts = parser.parse_args()
    seq = loop_sequence()
    for seed in opts.seeds:
        t0 = time.perf_counter()
        res = pipeline.run_experiment(seq, VOConfig(scale_mode="hold"), seed=seed, backend="pose_graph")
        info = res.backend_info
        print(json.dumps(dict(
            seed=seed,
            ate_rmse=float(res.ate.rmse),
            n_keyframes=int(info["n_keyframes"]),
            n_bridge_pairs=int(info.get("n_bridge_pairs", 0)),
            n_loop_edges=int(info["n_loop_edges"]),
            loop_pairs=[[int(i), int(j)] for i, j in info.get("loop_pairs", [])],
            pg_initial_cost=info.get("pg_initial_cost"),
            pg_final_cost=info.get("pg_final_cost"),
            seconds=time.perf_counter() - t0,
        )), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
