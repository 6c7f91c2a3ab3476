"""TUM-format trajectory I/O — port of droplet_visual_odometry_tpu/eval/tum.py.

Same six stream names and the same line format ("t tx ty tz qx qy qz qw",
each value printed with %r) as the reference; poses go through float32
like the reference's jnp conversion.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from droplet_visual_odometry_tpu_torch.core import se3

STREAM_NAMES = (
    "stamped_ground_truth_absolute.txt",
    "stamped_ground_truth_relative.txt",
    "stamped_ground_truth_velocity.txt",
    "stamped_traj_estimate_absolute.txt",
    "stamped_traj_estimate_relative.txt",
    "stamped_traj_estimate_velocity.txt",
)


def _f32(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=torch.float32)


def write_tum(path: str, timestamps: np.ndarray, poses: np.ndarray) -> None:
    """Write (N,) stamps + (N, 4, 4) poses as TUM lines (truncating)."""
    t, q = se3.to_translation_quaternion(_f32(poses))
    t, q = t.numpy(), q.numpy()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for i in range(len(timestamps)):
            f.write(
                "%r %r %r %r %r %r %r %r\n"
                % (
                    float(timestamps[i]),
                    float(t[i, 0]), float(t[i, 1]), float(t[i, 2]),
                    float(q[i, 0]), float(q[i, 1]), float(q[i, 2]), float(q[i, 3]),
                )
            )


def read_tum(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Read a TUM file -> ((N,) stamps, (N, 4, 4) float32 poses)."""
    data = np.loadtxt(path, ndmin=2)
    poses = se3.from_translation_quaternion(_f32(data[:, 1:4]), _f32(data[:, 4:8]))
    return data[:, 0], poses.numpy()


def velocity_stream(timestamps: np.ndarray, poses: np.ndarray) -> np.ndarray:
    """Finite-difference velocity 4x4 stream (N-1, 4, 4)."""
    ts = _f32(timestamps)
    P = _f32(poses)
    return se3.velocity_between_timestamps(P[:-1], P[1:], ts[:-1], ts[1:]).numpy()


def write_experiment_streams(
    out_dir: str,
    timestamps: np.ndarray,
    gt_abs: np.ndarray,
    gt_rel: np.ndarray,
    vo_abs: np.ndarray,
    vo_rel: np.ndarray,
) -> dict[str, str]:
    """Write the six canonical streams; rel streams are stamped with the
    current frame's time. Returns {stream_name: path}."""
    ts = np.asarray(timestamps)
    payload = {
        "stamped_ground_truth_absolute.txt": (ts, gt_abs),
        "stamped_ground_truth_relative.txt": (ts[1:], gt_rel),
        "stamped_ground_truth_velocity.txt": (ts[1:], velocity_stream(ts, gt_abs)),
        "stamped_traj_estimate_absolute.txt": (ts, vo_abs),
        "stamped_traj_estimate_relative.txt": (ts[1:], vo_rel),
        "stamped_traj_estimate_velocity.txt": (ts[1:], velocity_stream(ts, vo_abs)),
    }
    paths = {}
    for name, (t_arr, p_arr) in payload.items():
        paths[name] = os.path.join(out_dir, name)
        write_tum(paths[name], t_arr, p_arr)
    return paths
