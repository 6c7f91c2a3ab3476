"""Post-hoc trajectory analysis CLI — port of droplet_visual_odometry_tpu/cli/analyze.py.

Reads an experiment directory holding the six stamped_*.txt streams, prints
per-axis std/mean for each, ATE/RPE between the ground-truth and estimate
absolute streams and their raw GT-vs-VO deltas, and optionally renders the
3-D plot. The analysis is host work (numpy, and torch on the CPU for the
euler angles), as the reference meant it to be: it never occupies the card.

Usage:
  python -m droplet_visual_odometry_tpu_torch.cli.analyze results/exp1 [--plot-dir results/exp1]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from droplet_visual_odometry_tpu_torch.eval import metrics, tum


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("experiment_dir")
    p.add_argument("--plot-dir", default=None)
    p.add_argument("--align", default="none", choices=["none", "se3", "sim3"])
    p.add_argument("--platform", default="cpu",
                   help="accepted for the reference's command line and ignored: "
                        "the port runs this analysis on the host")
    args = p.parse_args(argv)

    streams = {}
    for name in tum.STREAM_NAMES:
        path = os.path.join(args.experiment_dir, name)
        if os.path.exists(path):
            streams[name] = tum.read_tum(path)

    report: dict = {"per_stream_stats": {}}
    for name, (stamps, poses) in streams.items():
        st = metrics.per_axis_stats(poses)
        report["per_stream_stats"][name] = {
            k: np.round(v, 6).tolist() for k, v in st.items()
        }

    gt_name = "stamped_ground_truth_absolute.txt"
    vo_name = "stamped_traj_estimate_absolute.txt"
    if gt_name in streams and vo_name in streams:
        gt = np.linalg.inv(streams[gt_name][1])  # camera-in-marker frame
        vo = np.linalg.inv(streams[vo_name][1])
        n = min(len(gt), len(vo))
        a = metrics.ate(gt[:n], vo[:n], align=args.align)
        r = metrics.rpe(gt[:n], vo[:n])
        report["ate"] = {"rmse": a.rmse, "mean": a.mean, "median": a.median, "max": a.max}
        report["rpe"] = {"trans_rmse": r.trans_rmse, "rot_rmse_deg": r.rot_rmse_deg}
        # Raw-stream GT-vs-VO deltas, on the cTm streams exactly as logged.
        diff = metrics.gt_vo_difference(streams[gt_name][1][:n], streams[vo_name][1][:n])
        report["gt_vo_difference"] = {
            "euclidean_mean": float(diff["euclidean"].mean()),
            "euclidean_max": float(diff["euclidean"].max()),
            "translation_diff_std": np.round(diff["translation_diff"].std(0), 6).tolist(),
            "euler_diff_std": np.round(diff["euler_diff"].std(0), 6).tolist(),
        }
        if args.plot_dir:
            from droplet_visual_odometry_tpu_torch.eval.plots import plot_trajectory_3d

            os.makedirs(args.plot_dir, exist_ok=True)
            plot_trajectory_3d(
                os.path.join(args.plot_dir, "trajectory_3d.png"),
                {"ground_truth": gt[:n, :3, 3], "vo_estimate": vo[:n, :3, 3]},
            )
            report["plot"] = os.path.join(args.plot_dir, "trajectory_3d.png")

    print(json.dumps(report, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
