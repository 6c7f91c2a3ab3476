#!/usr/bin/env python3
"""Reference figures of the JAX package's "ours" rows of parity.py, over
RANSAC seeds, which the PyTorch port's parity harness
(droplet_visual_odometry_tpu_torch/parity.py) and chip_smoke.py's phase P
hold the port to.

    JAX_PLATFORMS=cpu python tools/jax_parity_figures.py [--seeds 0 1 2 3] [--scenarios clean ...]

Renders parity.py's five full-size scenarios (parity.scenarios(quick=False))
and runs the JAX package's run_experiment for every "ours" row of
parity.run_scenario: none, ba, pose_graph and the default (pose_graph+hold)
everywhere, sift and surf on clean and corner_noise_1px, with parity.py's
scale_mode rule (hold on marker_gap), its all_seeds flags (on marker_gap the
none and default rows are the mean over render seeds 3/13/23, the others
run on seed 3 alone) and its (backend, scale_mode, frontend) cache. The
RANSAC seed is the only thing that changes between lines; seed 0 is
PARITY.md's run.

Prints one JSON line per scenario, row and RANSAC seed: the row's ATE RMSE
(the mean over its render seeds), each render seed's ATE and the wall.
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

import parity  # noqa: E402

# parity.run_scenario's full-mode "ours" rows, as the port's harness holds them.
from droplet_visual_odometry_tpu_torch.parity import SCENARIOS, ours_rows  # noqa: E402


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    parser.add_argument("--scenarios", nargs="+", default=list(SCENARIOS), choices=SCENARIOS)
    opts = parser.parse_args()
    scen = parity.scenarios(quick=False)
    for name in opts.scenarios:
        seqs = scen[name] if isinstance(scen[name], list) else [scen[name]]
        for seed in opts.seeds:
            samples: dict[str, list[float]] = {}
            walls: dict[str, float] = {}
            for si, sq in enumerate(seqs):
                cache = {}
                for label, backend, scale_mode, frontend, all_seeds in ours_rows(name):
                    if si > 0 and not all_seeds:
                        continue
                    key = (backend, scale_mode, frontend)
                    if key not in cache:
                        t0 = time.perf_counter()
                        pres, est = parity.run_ours(
                            sq, backend=backend, scale_mode=scale_mode, seed=seed, frontend=frontend
                        )
                        cache[key] = (parity.evaluate(sq, pres, est)["ate_rmse_m"], time.perf_counter() - t0)
                    samples.setdefault(label, []).append(cache[key][0])
                    walls[label] = walls.get(label, 0.0) + cache[key][1]
            for label, ates in samples.items():
                print(json.dumps(dict(
                    scenario=name, row=label, seed=seed,
                    ate_rmse_m=round(float(np.mean(ates)), 6), per_render_seed=ates,
                    seconds=round(walls[label], 3),
                )), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
