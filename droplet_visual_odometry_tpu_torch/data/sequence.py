"""Sequence container + on-disk format — port of droplet_visual_odometry_tpu/data/sequence.py.

Numpy only, and the SAME .npz layout as the reference, so a file written by
either package is read by the other. The reference docstring follows.

Sequence container + on-disk format: the replacement for rosbag ingestion.

The reference reads a ROS bag, collects `/camera_array/cam1/image_raw/compressed`
images and `/stag_markers` detections, and pairs them by exactly-equal header
timestamps (reference: scripts/get_valid_message_stream.py:21-68, 80-87; marker
messages with zero markers are dropped at :32-34). Here the equivalent is a
fixed-shape array "sequence": decoded grayscale frames + per-frame marker
detections + stamps, stored as one .npz — the host-side data plane that feeds
device batches.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Sequence as Seq

import numpy as np

from droplet_visual_odometry_tpu_torch.core.camera import Camera, make_camera


@dataclasses.dataclass
class VOSequence:
    """A paired (image, marker) stream with fixed shapes.

    frames:         (N, H, W) uint8 grayscale, already decoded (the analog of
                    the reference's imdecode+cvtColor host step, v3:115-135).
    timestamps:     (N,) float64 seconds.
    marker_corners: (N, 4, 2) float32 pixel corners of the reference fiducial,
                    NaN rows where the marker was not detected.
    marker_poses:   (N, 4, 4) float32 camera_T_marker from the detector
                    (the STag pose channel used for ground truth, gt:103-149),
                    identity rows where absent.
    marker_present: (N,) bool.
    marker_ids:     (N,) int32 id of the detected reference marker (-1 absent).
    camera:         intrinsics/distortion of the capturing camera.
    real_marker_length: physical side length of the fiducial (metres) — the
                    metric-scale anchor (v3:263-291).
    gt_poses:       optional (N, 4, 4) float32 analytic world_T_camera ground
                    truth — synthetic sequences only; real data derives GT from
                    marker_poses like the reference does.
    landmarks:      optional (L, 3) float32 world positions of the synthetic
                    scene landmarks (for exact data-association checks in tests).
    """

    frames: np.ndarray
    timestamps: np.ndarray
    marker_corners: np.ndarray
    marker_poses: np.ndarray
    marker_present: np.ndarray
    marker_ids: np.ndarray
    camera: Camera
    real_marker_length: float
    gt_poses: np.ndarray | None = None
    landmarks: np.ndarray | None = None

    def __len__(self) -> int:
        return int(self.frames.shape[0])

    @property
    def height(self) -> int:
        return int(self.frames.shape[1])

    @property
    def width(self) -> int:
        return int(self.frames.shape[2])

    def validate(self) -> None:
        n = len(self)
        assert self.frames.ndim == 3 and self.frames.dtype == np.uint8
        assert self.timestamps.shape == (n,)
        assert self.marker_corners.shape == (n, 4, 2)
        assert self.marker_poses.shape == (n, 4, 4)
        assert self.marker_present.shape == (n,)
        assert self.marker_ids.shape == (n,)
        assert np.all(np.diff(self.timestamps) > 0), "timestamps must be sorted"


def save(path: str, seq: VOSequence) -> None:
    """Write a sequence as one .npz + sidecar camera JSON metadata."""
    seq.validate()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = dict(
        frames=seq.frames,
        timestamps=seq.timestamps,
        marker_corners=seq.marker_corners,
        marker_poses=seq.marker_poses,
        marker_present=seq.marker_present,
        marker_ids=seq.marker_ids,
        camera_K=np.asarray(seq.camera.K, np.float64),
        camera_dist=np.asarray(seq.camera.dist, np.float64),
        camera_size=np.asarray([seq.camera.width, seq.camera.height], np.int64),
        real_marker_length=np.asarray(seq.real_marker_length, np.float64),
    )
    if seq.gt_poses is not None:
        payload["gt_poses"] = seq.gt_poses
    if seq.landmarks is not None:
        payload["landmarks"] = seq.landmarks
    np.savez_compressed(path, **payload)


def load(path: str) -> VOSequence:
    z = np.load(path)
    K = z["camera_K"]
    w, h = (int(x) for x in z["camera_size"])
    cam = make_camera(K[0, 0], K[1, 1], K[0, 2], K[1, 2], z["camera_dist"], w, h)
    seq = VOSequence(
        frames=z["frames"],
        timestamps=z["timestamps"],
        marker_corners=z["marker_corners"].astype(np.float32),
        marker_poses=z["marker_poses"].astype(np.float32),
        marker_present=z["marker_present"].astype(bool),
        marker_ids=z["marker_ids"].astype(np.int32),
        camera=cam,
        real_marker_length=float(z["real_marker_length"]),
        gt_poses=z["gt_poses"].astype(np.float32) if "gt_poses" in z else None,
        landmarks=z["landmarks"].astype(np.float32) if "landmarks" in z else None,
    )
    seq.validate()
    return seq


def pair_timestamps(image_stamps: Seq[float], marker_stamps: Seq[float]) -> np.ndarray:
    """Exact-equality timestamp intersection, sorted ascending: the
    reference's pairing rule (set(image_map) & set(marker_map), then sorted).
    Frames without a same-stamp marker detection are dropped, and vice versa."""
    common = sorted(set(np.asarray(image_stamps).tolist()) & set(np.asarray(marker_stamps).tolist()))
    return np.asarray(common, dtype=np.float64)


def build_paired_sequence(
    image_stamps: np.ndarray,
    frames: np.ndarray,
    marker_stamps: np.ndarray,
    marker_corners: np.ndarray,
    marker_poses: np.ndarray,
    marker_ids: np.ndarray,
    camera: Camera,
    real_marker_length: float,
) -> VOSequence:
    """Assemble a VOSequence from separate image and marker streams by
    exact-stamp pairing. Marker entries whose id < 0 (the analog of empty
    marker messages) are dropped before pairing."""
    valid = marker_ids >= 0
    marker_stamps = marker_stamps[valid]
    marker_corners = marker_corners[valid]
    marker_poses = marker_poses[valid]
    marker_ids = marker_ids[valid]

    common = pair_timestamps(image_stamps, marker_stamps)
    img_index = {float(t): i for i, t in enumerate(image_stamps)}
    mrk_index = {float(t): i for i, t in enumerate(marker_stamps)}
    ii = np.asarray([img_index[float(t)] for t in common], np.int64)
    mi = np.asarray([mrk_index[float(t)] for t in common], np.int64)
    return VOSequence(
        frames=frames[ii],
        timestamps=common,
        marker_corners=marker_corners[mi].astype(np.float32),
        marker_poses=marker_poses[mi].astype(np.float32),
        marker_present=np.ones(len(common), bool),
        marker_ids=marker_ids[mi].astype(np.int32),
        camera=camera,
        real_marker_length=real_marker_length,
    )
