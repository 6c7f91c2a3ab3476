"""Experiment runner CLI — port of droplet_visual_odometry_tpu/cli/run_experiment.py,
with the same flags and defaults.

The run goes to the card unless `--platform cpu` is given; a missing card
raises (the port never moves a run to the CPU by itself). `--profile-dir`
writes a torch.profiler Chrome trace of the run there. The printed JSON
summary has the reference's keys.

Usage:
  python -m droplet_visual_odometry_tpu_torch.cli.run_experiment \\
      --sequence path/to/seq.npz --out-dir results/exp1
  python -m droplet_visual_odometry_tpu_torch.cli.run_experiment \\
      --synthetic --n-frames 60 --out-dir results/synth [--platform cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--sequence", help="path to a VOSequence .npz")
    src.add_argument("--synthetic", action="store_true", help="render a synthetic sequence")
    src.add_argument("--config", help="experiment YAML (utils.config.ExperimentConfig)")
    p.add_argument("--out-dir", default=None, help="directory for the six TUM streams")
    p.add_argument("--match-mode", default="crosscheck", choices=["crosscheck", "ratio"],
                   help="matching mode (reference 'orb' vs SIFT/KNN ratio modes)")
    p.add_argument("--frontend", default="orb", choices=["orb", "sift", "surf"],
                   help="feature family — the reference's mode switch")
    p.add_argument("--keypoints", type=int, default=512)
    p.add_argument("--fast-threshold", type=float, default=20.0)
    p.add_argument("--n-levels", type=int, default=4,
                   help="ORB pyramid levels (1 = single-scale)")
    p.add_argument("--scale-factor", type=float, default=1.32,
                   help="ORB pyramid level ratio")
    p.add_argument("--ransac-hypotheses", type=int, default=1024)
    p.add_argument("--ransac-threshold-px", type=float, default=1.0)
    p.add_argument("--scale-side", default="mean", choices=["mean", "reference"])
    p.add_argument("--scale-mode", default="hold", choices=["marker", "hold"],
                   help="metric scale: per-pair marker (1.0 fallback, the "
                   "reference's behavior) or hold-last-live (default; identical "
                   "while a live marker scale exists, forward-fills through "
                   "marker gaps)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--backend", default="pose_graph",
                   choices=["none", "ba", "pose_graph"],
                   help="trajectory refinement: windowed keyframe BA, "
                   "loop-closure pose graph (default), or 'none' for the "
                   "raw frame-to-frame chain (the reference's behavior)")
    p.add_argument("--checkpoint", default=None,
                   help="npz path for chunked checkpoint/resume of long runs")
    p.add_argument("--checkpoint-chunk", type=int, default=256)
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler Chrome trace of the run into this dir")
    p.add_argument("--plot", default=None, help="write a 3-D GT-vs-VO plot PNG here")
    p.add_argument("--dump-matches", type=int, default=0, metavar="N",
                   help="write matched-keypoint debug images (RANSAC inliers "
                   "green/outliers red) for N evenly spaced frame pairs into "
                   "OUT_DIR/debug")
    p.add_argument("--platform", default=None, choices=["cpu", "cuda"],
                   help="where the run goes: the card unless 'cpu'")
    # synthetic options
    p.add_argument("--n-frames", type=int, default=60)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--landmarks", type=int, default=350)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from droplet_visual_odometry_tpu_torch import pipeline
    from droplet_visual_odometry_tpu_torch.data import sequence as seq_mod
    from droplet_visual_odometry_tpu_torch.data import synthetic
    from droplet_visual_odometry_tpu_torch.estimation.ransac import RansacConfig
    from droplet_visual_odometry_tpu_torch.estimation.vo import VOConfig
    from droplet_visual_odometry_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.platform or "cuda")
    if args.config:
        from droplet_visual_odometry_tpu_torch.utils import config as config_mod

        exp = config_mod.load(args.config)
        if not exp.sequence:
            raise SystemExit("--config requires a 'sequence' path in the YAML")
        seq = seq_mod.load(exp.sequence)
        args.out_dir = args.out_dir or (exp.out_dir or None)
        args.seed = exp.seed
        args.backend = exp.backend
        args.checkpoint = args.checkpoint or (exp.checkpoint_path or None)
        cfg = exp.vo
    elif args.synthetic:
        seq = synthetic.render_sequence(
            synthetic.SyntheticConfig(
                n_frames=args.n_frames,
                width=args.width,
                height=args.height,
                n_landmarks=args.landmarks,
            )
        )
    else:
        seq = seq_mod.load(args.sequence)

    if not args.config:
        cfg = VOConfig(
            n_keypoints=args.keypoints,
            frontend=args.frontend,
            fast_threshold=args.fast_threshold,
            n_levels=args.n_levels,
            scale_factor=args.scale_factor,
            match_mode=args.match_mode,
            ransac=RansacConfig(
                n_hypotheses=args.ransac_hypotheses,
                threshold_px=args.ransac_threshold_px,
            ),
            scale_side=args.scale_side,
            scale_mode=args.scale_mode,
        )

    profile_ctx = contextlib.nullcontext()
    if args.profile_dir:
        from droplet_visual_odometry_tpu_torch.utils import profiling

        profile_ctx = profiling.trace(args.profile_dir)

    print(f"running {len(seq)} frames on device={device}...", file=sys.stderr, flush=True)
    t0 = time.time()
    with profile_ctx:
        res = pipeline.run_experiment(
            seq,
            cfg,
            out_dir=args.out_dir,
            seed=args.seed,
            backend=args.backend,
            checkpoint_path=args.checkpoint,
            checkpoint_chunk=args.checkpoint_chunk,
            device=device,
        )
    wall = time.time() - t0

    summary = {
        "n_frames": len(seq),
        "ate_rmse_m": res.ate.rmse,
        "ate_max_m": res.ate.max,
        "rpe_trans_rmse_m": res.rpe.trans_rmse,
        "rpe_rot_rmse_deg": res.rpe.rot_rmse_deg,
        "median_matches": int(np.median(res.trajectory.n_matches)),
        "median_inliers": int(np.median(res.trajectory.n_inliers)),
        "ok_fraction": float(np.mean(res.trajectory.ok)),
        "wall_seconds": wall,
        "frames_per_second": len(seq) / wall,
        "config": dataclasses.asdict(cfg),
        "streams": res.stream_paths,
    }
    print(json.dumps(summary, indent=2))

    if args.dump_matches:
        debug_dir = os.path.join(args.out_dir or ".", "debug")
        written = pipeline.dump_match_images(
            seq, cfg, debug_dir, n_pairs=args.dump_matches, seed=args.seed, device=device
        )
        print(json.dumps({"debug_images": written}, indent=2))

    if args.plot:
        from droplet_visual_odometry_tpu_torch.eval.plots import plot_trajectory_3d

        plot_trajectory_3d(
            args.plot,
            {
                "ground_truth": np.linalg.inv(res.gt_abs)[:, :3, 3],
                "vo_estimate": np.linalg.inv(res.vo_abs)[:, :3, 3],
            },
            title="camera trajectory (marker frame)",
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
