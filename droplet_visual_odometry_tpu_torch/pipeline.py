"""End-to-end experiment pipeline (backend "none") — port of
droplet_visual_odometry_tpu/pipeline.py.

Take a paired sequence, undistort its frames on the device, run per-pair VO
seeded from the first marker pose, anchor, and emit ATE/RPE and the six TUM
streams. The entry points run on the card unless the caller asks for the
CPU (`device="cpu"`, as the tests do); `"cuda"` without a GPU raises.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from droplet_visual_odometry_tpu_torch.core import camera as camera_mod
from droplet_visual_odometry_tpu_torch.core import se3
from droplet_visual_odometry_tpu_torch.data.sequence import VOSequence
from droplet_visual_odometry_tpu_torch.estimation.vo import VOConfig, VOTrajectory, run_sequence
from droplet_visual_odometry_tpu_torch.eval import metrics, tum


@dataclasses.dataclass
class ExperimentResult:
    timestamps: np.ndarray
    gt_abs: np.ndarray  # (N, 4, 4) cTm ground truth
    gt_rel: np.ndarray  # (N-1, 4, 4)
    vo_abs: np.ndarray  # (N, 4, 4)
    vo_rel: np.ndarray  # (N-1, 4, 4)
    trajectory: VOTrajectory  # fields as numpy arrays
    ate: metrics.ATEResult
    rpe: metrics.RPEResult
    stream_paths: dict[str, str] | None = None
    backend_info: dict | None = None


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but no CUDA device is available")
    return dev


def make_preprocessor(seq: VOSequence, device="cuda"):
    """Chunk preprocessor: raw (C, H, W) uint8 host frames -> (C, H, W)
    float32 undistorted frames on `device`. Frames cross to the device in
    their raw dtype; the cast and the bilinear remap run there."""
    dev = resolve_device(device)
    if not np.any(seq.camera.dist):
        return lambda chunk: torch.as_tensor(np.asarray(chunk)).to(dev).to(torch.float32)
    new_K = camera_mod.optimal_new_camera_matrix(seq.camera, alpha=1.0)
    src_map = camera_mod.undistort_rectify_map(seq.camera, new_K, device=dev)
    return lambda chunk: camera_mod.remap_bilinear(torch.as_tensor(np.asarray(chunk)).to(dev), src_map)


def preprocess_frames(seq: VOSequence, device="cuda") -> torch.Tensor:
    return make_preprocessor(seq, device)(seq.frames)


def effective_K(seq: VOSequence) -> np.ndarray:
    """Intrinsics valid for the (possibly undistorted) frames fed to VO."""
    if not np.any(seq.camera.dist):
        return np.asarray(seq.camera.K)
    return camera_mod.optimal_new_camera_matrix(seq.camera, alpha=1.0)


def effective_marker_corners(seq: VOSequence, new_K: np.ndarray) -> np.ndarray:
    """Marker corners in the pixel space of the preprocessed frames (NaN kept)."""
    corners = np.asarray(seq.marker_corners, np.float32)
    if not np.any(seq.camera.dist):
        return corners
    und = camera_mod.undistort_points(torch.from_numpy(np.nan_to_num(corners)), seq.camera, new_K=new_K)
    return np.where(np.isnan(corners), np.nan, und.numpy().astype(np.float32))


def gt_streams(seq: VOSequence) -> tuple[np.ndarray, np.ndarray]:
    """Marker ground truth: absolute cTm per frame and relative
    cTm_curr @ inv(cTm_prev) (float32, like the reference)."""
    gt_abs = np.asarray(seq.marker_poses, np.float64)
    g = torch.as_tensor(gt_abs, dtype=torch.float32)
    return gt_abs, se3.gt_relative(g[:-1], g[1:]).numpy()


def run_experiment(
    seq: VOSequence,
    cfg: VOConfig = VOConfig(),
    out_dir: str | None = None,
    seed: int = 0,
    backend: str = "none",
    checkpoint_path: str | None = None,
    stream: bool | None = None,
    *,
    device="cuda",
) -> ExperimentResult:
    """Full experiment on one sequence on `device` ("cuda" or "cpu"). Writes
    the six TUM streams when out_dir is given. Only backend "none" and the
    in-memory path are ported; the others raise NotImplementedError."""
    if backend == "pose_graph":
        raise NotImplementedError("backend 'pose_graph' is not ported yet (ROADMAP A8)")
    if backend == "ba":
        raise NotImplementedError("backend 'ba' is not ported yet (ROADMAP A10)")
    if backend != "none":
        raise ValueError(f"unknown backend: {backend}")
    frame_f32_bytes = 4 * int(np.prod(seq.frames.shape))
    if stream or checkpoint_path or (stream is None and frame_f32_bytes > 2 << 30):
        raise NotImplementedError(
            "the chunked streaming path (stream=True, a checkpoint, or frames over 2 GB as "
            "float32) is not ported yet (ROADMAP A9: utils/checkpoint.py)"
        )
    dev = resolve_device(device)

    K = effective_K(seq).astype(np.float32)
    corners = effective_marker_corners(seq, K)
    first = int(np.argmax(seq.marker_present)) if seq.marker_present.any() else 0
    init_pose = np.asarray(seq.marker_poses[first], np.float32)

    frames = make_preprocessor(seq, dev)(seq.frames)
    traj = run_sequence(
        frames, corners, np.asarray(seq.marker_present), init_pose, K,
        seq.real_marker_length, cfg, seed=seed,
    )
    traj = VOTrajectory(*(t.cpu().numpy() for t in traj))

    gt_abs, gt_rel = gt_streams(seq)
    vo_abs = np.asarray(traj.abs_poses, np.float64)
    # Anchor at the first marker-bearing frame: abs_i <- abs_i @ inv(abs_first) @ init_pose.
    if first > 0:
        vo_abs = vo_abs @ (np.linalg.inv(vo_abs[first]) @ np.asarray(init_pose, np.float64))

    v = torch.as_tensor(vo_abs, dtype=torch.float32)
    vo_rel = se3.gt_relative(v[:-1], v[1:]).numpy().astype(np.float64)

    # Metrics on the camera trajectory in the marker frame (mTc = inv(cTm)).
    present = seq.marker_present
    gt_cam = np.linalg.inv(gt_abs[present])
    vo_cam = np.linalg.inv(vo_abs[present])
    paths = None
    if out_dir is not None:
        paths = tum.write_experiment_streams(out_dir, seq.timestamps, gt_abs, gt_rel, vo_abs, vo_rel)
    return ExperimentResult(
        timestamps=seq.timestamps,
        gt_abs=gt_abs,
        gt_rel=gt_rel,
        vo_abs=vo_abs,
        vo_rel=vo_rel,
        trajectory=traj,
        ate=metrics.ate(gt_cam, vo_cam, align="none"),
        rpe=metrics.rpe(gt_cam, vo_cam, delta=1),
        stream_paths=paths,
        backend_info={},
    )
