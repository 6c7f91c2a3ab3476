"""A cell's inputs from its configuration, its traffic mix and the seed.

The configuration's clip is rendered from its own `clip_seed`: the same
recorded frames in every run, so that no seed changes the work (keyframe
counts, loop candidates and so the captured shapes follow the frames).
A run's `--seed` gives its RANSAC key. The clip's marker is kept where the
mix says, the clip cycled to the mix's sequence length, and handed to the
program as its own VOSequence and to the reference as plain arrays."""

from __future__ import annotations

import dataclasses

import numpy as np

from vobench import render


def ransac_seed(seed: int) -> int:
    """The RANSAC key's seed: the reference's PRNGKey takes 32 bits."""
    return int(seed) % 2**32


def synthetic_config(config: dict, traffic: dict) -> render.SyntheticConfig:
    cam = config["camera"]
    return render.SyntheticConfig(
        n_frames=int(traffic["clip_frames"]), width=cam["width"], height=cam["height"], fx=cam["fx"],
        fy=cam["fy"], cx=cam["cx"], cy=cam["cy"], distortion=np.asarray(cam["distortion"], np.float64),
        fps=float(config["fps"]), seed=int(config["clip_seed"]), **config["scene"],
    )


@dataclasses.dataclass
class Sequence:
    """The frames a call runs over (raw uint8, on the host) and their truth."""

    frames: np.ndarray
    timestamps: np.ndarray
    marker_corners: np.ndarray
    marker_poses: np.ndarray
    marker_present: np.ndarray
    clip_index: np.ndarray  # each frame's index in the rendered clip
    clip: render.Clip


def make_sequence(config: dict, traffic: dict, workers: int | None = None) -> Sequence:
    """Render the clip; keep its marker on the first and last `marker_keep`
    frames only (where the mix sets it); a sequence longer than the clip
    cycles over frames 0 .. clip-2 (the clip is a closed loop, its last
    frame at its first one's pose, so no step teleports)."""
    clip = render.render(synthetic_config(config, traffic), workers)
    keep = traffic.get("marker_keep")
    if keep:
        clip.marker_present[keep:-keep] = False
        clip.marker_corners[keep:-keep] = np.nan
    n, n_clip = int(traffic["sequence_frames"]), int(traffic["clip_frames"])
    idx = np.arange(n) if n <= n_clip else np.arange(n) % (n_clip - 1)
    return Sequence(
        frames=clip.frames[idx], timestamps=np.arange(n, dtype=np.float64) / float(config["fps"]),
        marker_corners=clip.marker_corners[idx], marker_poses=clip.marker_poses[idx],
        marker_present=clip.marker_present[idx], clip_index=idx, clip=clip,
    )


def program_sequence(seq: Sequence):
    """The program's VOSequence of the same arrays."""
    from droplet_visual_odometry_tpu_torch.core.camera import make_camera
    from droplet_visual_odometry_tpu_torch.data.sequence import VOSequence

    cam = seq.clip.camera
    return VOSequence(
        frames=seq.frames, timestamps=seq.timestamps, marker_corners=seq.marker_corners,
        marker_poses=seq.marker_poses, marker_present=seq.marker_present,
        marker_ids=np.where(seq.marker_present, 0, -1).astype(np.int32),
        camera=make_camera(float(cam.K[0, 0]), float(cam.K[1, 1]), float(cam.K[0, 2]), float(cam.K[1, 2]),
                           np.asarray(cam.dist), cam.width, cam.height),
        real_marker_length=seq.clip.marker_length,
    )
