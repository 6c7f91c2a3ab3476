"""Keyframe selection — port of droplet_visual_odometry_tpu/backend/keyframes.py.

Host numpy, as in the reference: a frame becomes a keyframe on geometric
displacement since the last keyframe, on tracking-quality decay, or after
max_gap frames.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class KeyframeConfig:
    min_translation: float = 0.05  # metres since last keyframe
    min_rotation_deg: float = 5.0  # degrees since last keyframe
    min_inliers: int = 60  # re-key when tracking quality drops below this
    max_gap: int = 10  # force a keyframe at least every N frames


def select_keyframes(
    abs_poses: np.ndarray,  # (N, 4, 4) VO absolute poses (cTm convention)
    n_inliers: np.ndarray,  # (N-1,) per-pair inlier counts
    cfg: KeyframeConfig = KeyframeConfig(),
) -> np.ndarray:
    """Boolean (N,) keyframe mask; frame 0 is always a keyframe."""
    n = len(abs_poses)
    keyframe = np.zeros(n, bool)
    keyframe[0] = True
    last = 0
    cam = np.linalg.inv(abs_poses)  # camera poses (marker frame)
    for i in range(1, n):
        dt = np.linalg.norm(cam[i][:3, 3] - cam[last][:3, 3])
        dR = cam[last][:3, :3].T @ cam[i][:3, :3]
        ang = np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)))
        weak = n_inliers[i - 1] < cfg.min_inliers if i - 1 < len(n_inliers) else False
        if (
            dt > cfg.min_translation
            or ang > cfg.min_rotation_deg
            or weak
            or (i - last) >= cfg.max_gap
        ):
            keyframe[i] = True
            last = i
    return keyframe
