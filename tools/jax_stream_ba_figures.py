#!/usr/bin/env python3
"""Reference figures of the JAX package's chunked streaming path and its
windowed-BA backend on the sequences that chip_smoke.py drives through the
PyTorch port.

    JAX_PLATFORMS=cpu python tools/jax_stream_ba_figures.py [--seeds 0 1 2 3] [--chunk 32] [--only stream|ba]

"stream": renders the 400-frame 1440x1080 out-and-back loop (the marker kept
only on the first and last 8 frames) and runs the JAX package's
run_experiment(backend="pose_graph") with VOConfig(scale_mode="hold"), the
default PoseGraphRefineConfig and a checkpoint path, so it takes the chunked
streaming path, once per RANSAC seed. The chunk size changes only the random
keys of the pairs (each chunk folds its start index into the run key), so a
chunk smaller than the port's 256 keeps the reference's memory small on a CPU.

"ba": renders the 48-frame loop of chip_smoke.py's pose-graph phase and runs
run_experiment(backend="ba") with VOConfig(scale_mode="hold") and the default
RefineConfig once per seed.

Prints one JSON line per phase and seed: the ATE RMSE and the backend's
structure. chip_smoke.py holds the port to these figures.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from droplet_visual_odometry_tpu import pipeline  # noqa: E402
from droplet_visual_odometry_tpu.data import synthetic  # noqa: E402
from droplet_visual_odometry_tpu.estimation.vo import VOConfig  # noqa: E402

# chip_smoke.py's LOOP_SEQ_CONFIG (48 frames) and its stream phase's 400-frame form.
LOOP_SEQ_CONFIG = dict(
    n_frames=48, width=1440, height=1080, fx=1170.0, fy=1170.0, n_landmarks=900, landmark_size=0.07,
    orbit_sweep=0.6, dolly=0.5, loop=True, noise_std=1.5,
)
STREAM_FRAMES = 400
MARKER_KEEP = 8


def loop_sequence(n_frames: int):
    seq = synthetic.render_sequence(synthetic.SyntheticConfig(**dict(LOOP_SEQ_CONFIG, n_frames=n_frames)))
    present = seq.marker_present.copy()
    corners = seq.marker_corners.copy()
    present[MARKER_KEEP:-MARKER_KEEP] = False
    corners[MARKER_KEEP:-MARKER_KEEP] = np.nan
    return dataclasses.replace(seq, marker_present=present, marker_corners=corners)


def stream_figures(seeds, chunk: int) -> None:
    seq = loop_sequence(STREAM_FRAMES)
    for seed in seeds:
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as d:
            res = pipeline.run_experiment(
                seq, VOConfig(scale_mode="hold"), seed=seed, backend="pose_graph",
                checkpoint_path=os.path.join(d, "state.npz"), checkpoint_chunk=chunk,
            )
        info = res.backend_info
        print(json.dumps(dict(
            phase="stream", seed=seed, n_frames=STREAM_FRAMES, chunk=chunk,
            ate_rmse=float(res.ate.rmse),
            n_keyframes=int(info["n_keyframes"]),
            n_bridge_pairs=int(info.get("n_bridge_pairs", 0)),
            n_loop_edges=int(info["n_loop_edges"]),
            ok_fraction=float(np.mean(np.asarray(res.trajectory.ok))),
            n_matches_total=int(np.sum(np.asarray(res.trajectory.n_matches))),
            seconds=time.perf_counter() - t0,
        )), flush=True)


def ba_figures(seeds) -> None:
    seq = loop_sequence(LOOP_SEQ_CONFIG["n_frames"])
    for seed in seeds:
        t0 = time.perf_counter()
        res = pipeline.run_experiment(seq, VOConfig(scale_mode="hold"), seed=seed, backend="ba")
        info = res.backend_info
        corr = info.get("window_corr", [])
        print(json.dumps(dict(
            phase="ba", seed=seed,
            ate_rmse=float(res.ate.rmse),
            n_keyframes=int(info["n_keyframes"]),
            windows=int(info["windows"]),
            accepted=[i for i, r in enumerate(corr) if r["accepted"]],
            rms_px=[float(v) for v in info["rms_px"]],
            window_corr=corr,
            seconds=time.perf_counter() - t0,
        )), flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    parser.add_argument("--chunk", type=int, default=32, help="checkpoint_chunk of the streamed runs")
    parser.add_argument("--only", choices=("stream", "ba"), default=None)
    opts = parser.parse_args()
    if opts.only in (None, "ba"):
        ba_figures(opts.seeds)
    if opts.only in (None, "stream"):
        stream_figures(opts.seeds, opts.chunk)
    return 0


if __name__ == "__main__":
    sys.exit(main())
